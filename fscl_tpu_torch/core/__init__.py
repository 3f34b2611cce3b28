from fscl_tpu_torch.core.config import (
    AudioConfig,
    CodebookConfig,
    ModelConfig,
    SpeakerConfig,
    TransformerConfig,
    UpstreamConfig,
    VarianceConfig,
    VarianceEmbeddingConfig,
    VariancePredictorConfig,
    VocoderConfig,
    model_config_from_yaml,
)
from fscl_tpu_torch.core.device import resolve_device
from fscl_tpu_torch.core.stats import DEFAULT_STATS, FeatureStats, GlobalStats
