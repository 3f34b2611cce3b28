from fscl_tpu_torch.obs.loggers import (
    Callback, CheckpointCallback, CSVSaver, LossTableLogger, TensorBoardLogger,
)
from fscl_tpu_torch.obs.figures import plot_attention, plot_layer_weights, plot_mel
from fscl_tpu_torch.obs.codebook_analysis import CodebookAnalyzer, MatchingGraphInfo
from fscl_tpu_torch.obs.profiling import PhaseTimer, trace
from fscl_tpu_torch.obs.synth_saver import SynthSaver
