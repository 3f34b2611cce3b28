"""Port of fscl_tpu/systems: the systems of the main path, registered under
fscl_tpu's keys (`baseline`/`baseline-tune`, `fscl`/`fscl-orig`,
`fscl-orig-tune`/`fscl-tune`, the T2U family's `tacot2u`, `fscl-t2u*`, and
the PR family's `pr-*`); `systems/factory.py:build_system` builds the T2U
and PR keys from configs."""
from fscl_tpu_torch.systems.base import System, TrainState
from fscl_tpu_torch.systems.baseline import BaselineSystem
from fscl_tpu_torch.systems.fscl import Episode, TransEmbSystem, transplant_embedding
from fscl_tpu_torch.systems.pr import (
    PRBatch, PREpisode, SSLBaselineSystem, SSLClusterSystem, SSLLinearSystem, SSLProtoNetSystem,
    TransHeadPRSystem,
)
from fscl_tpu_torch.systems.t2u import (
    TacoT2USystem, TransEmbC2T2USystem, TransEmbCT2USystem, TransEmbT2USystem,
)
from fscl_tpu_torch.systems.t2u_tune import (
    DAE2ETuneSystem, DATuneSystem, E2ETuneSystem, T2UTuneSystem, t2u_tune_init,
)
from fscl_tpu_torch.systems.tune import TransEmbTuneSystem, adapt_on_chip, tune_init


def get_system(algorithm_type: str):
    """System registry lookup (port of `fscl_tpu/systems/__init__.py:28`):
    a key that fscl_tpu registers and the port does not have yet raises
    NotImplementedError naming its ROADMAP item."""
    from fscl_tpu_torch.core.registry import SYSTEMS
    return SYSTEMS.get(algorithm_type)
