"""Port of fscl_tpu/systems: every system, registered under fscl_tpu's keys
(`baseline`/`baseline-tune`, `fscl`/`fscl-orig`, `fscl-orig-tune`/
`fscl-tune`, the meta-learning variants `fscl-orig2`/`maml`/`meta`,
`imaml`, `fscl-ada*`, `fscl-ssl_ada*`, `conti-ae`, `semi-fscl*`, the T2U
family's `tacot2u`, `fscl-t2u*`, and the PR family's `pr-*`);
`systems/factory.py:build_system` builds every key but the main path's
from configs."""
from fscl_tpu_torch.systems.base import System, TrainState
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.ada import SSLEpisode, TransEmbADASystem, TransEmbSSLADASystem
from fscl_tpu_torch.systems.conti_ae import (
    ContiAEBatch, ContiAESystem, SemiEpisode, SemiTransEmbSystem,
)
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem, transplant_embedding
from fscl_tpu_torch.systems.maml import IMAMLTransEmbSystem, MAMLTransEmbSystem, inner_adapt
from fscl_tpu_torch.systems.pr import (
    PRBatch, PREpisode, SSLBaselineSystem, SSLClusterSystem, SSLLinearSystem, SSLProtoNetSystem,
    TransHeadPRSystem,
)
from fscl_tpu_torch.systems.t2u import (
    TacoT2USystem, TransEmbC2T2USystem, TransEmbCT2USystem, TransEmbT2USystem, schedule_f,
)
from fscl_tpu_torch.systems.t2u_tune import (
    DAE2ETuneSystem, DATuneSystem, E2ETuneSystem, T2UTuneSystem, t2u_tune_init,
)
from fscl_tpu_torch.systems.tune import TransEmbTuneSystem, adapt_on_chip, tune_init


def get_system(algorithm_type: str):
    """System registry lookup (port of `fscl_tpu/systems/__init__.py:28`)."""
    from fscl_tpu_torch.core.registry import SYSTEMS
    return SYSTEMS.get(algorithm_type)
