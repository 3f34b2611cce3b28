"""Frozen model and training configuration objects.

The port's own copy of the model and training halves of
`fscl_tpu/core/config.py` (`:25-200`, `train_config_from_yaml` at `:381-433`
and `model_config_from_yaml` at `:442-522`): the same frozen dataclasses,
defaults and YAML reading, so a `config/model/*.yaml` or `config/train/*.yaml`
file gives the same config in both packages. Data and algorithm configs come
with the slices that need them.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import yaml


# ---------------------------------------------------------------------------
# Audio / feature configuration (reference: dlhlp_lib AUDIO_CONFIG +
# config/preprocess/*.yaml:18-28 — 22.05 kHz synthesis, 16 kHz SSL input,
# 1024-pt STFT, hop 256, 80 mel bins).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 22050
    ssl_sampling_rate: int = 16000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    # Pitch extraction frame period must line up with the mel hop.
    @property
    def frame_period_ms(self) -> float:
        return self.hop_length / self.sampling_rate * 1000.0


@dataclass(frozen=True)
class TransformerConfig:
    """FFT-block stack sizes (reference: config/model/base.yaml:1-27)."""
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 6
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2


@dataclass(frozen=True)
class VariancePredictorConfig:
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    pitch_quantization: str = "linear"   # "linear" | "log"
    energy_quantization: str = "linear"
    n_bins: int = 256


@dataclass(frozen=True)
class VarianceConfig:
    """Pitch/energy feature levels (reference: config/model/base.yaml)."""
    pitch_feature: str = "phoneme_level"    # "phoneme_level" | "frame_level"
    energy_feature: str = "phoneme_level"
    pitch_normalization: bool = True
    energy_normalization: bool = True


@dataclass(frozen=True)
class SpeakerConfig:
    emb_type: str = "table"  # "table" | "shared" | "encoder" | "dvec" | "scratch_encoder"
    n_speakers: int = 1
    # static per-utterance slice count for the d-vector paths: ragged
    # spk_ref_mel_slices are padded/truncated to this so batches stay
    # jit-stable (data/batch.py DvecRefs)
    n_ref_slices: int = 10

    @property
    def uses_dvec(self) -> bool:
        return self.emb_type in ("encoder", "dvec", "scratch_encoder")


@dataclass(frozen=True)
class CodebookConfig:
    """TransEmb codebook attention (reference: config/model/fscl-fastspeech2.yaml:1-8)."""
    size: int = 128
    num_heads: int = 4
    dim: int = 256          # output embedding dim (= encoder_hidden)


@dataclass(frozen=True)
class UpstreamConfig:
    """SSL upstream selection (reference: Define.set_upstream, Define.py:32-51)."""
    name: str = "hubert_large_ll60k"
    dim: int = 1024
    n_layers: int = 25      # embeddings + 24 transformer layers
    layer_idx: Optional[int] = None  # pin a single layer instead of learned weights
    # run the identical transformer layers as one lax.scan over stacked
    # params: same function, ~n_layers x smaller traced graph (faster jit
    # compiles of FSCL episode steps). Param layout converts with
    # models.hubert.stack_layer_params.
    scan_layers: bool = False
    # "bfloat16" runs the FROZEN forward-only upstream in bf16 (params +
    # activations); hidden states are cast back to f32 at the stop-gradient
    # boundary so everything downstream is unchanged. Measured 1.57x on
    # full-size FSCL episodes (12.7 -> 20.0 eps/s, loss identical to 3
    # decimals). Default f32 for bit-parity with the reference features.
    compute_dtype: str = "float32"

    @staticmethod
    def from_name(name: str, layer_idx: Optional[int] = None) -> "UpstreamConfig":
        if name == "mel":
            return UpstreamConfig(name="mel", dim=80, n_layers=1, layer_idx=layer_idx)
        if name in ("hubert", "wav2vec2"):
            return UpstreamConfig(name=name, dim=768, n_layers=13, layer_idx=layer_idx)
        # hubert_large_ll60k, wav2vec2_large_ll60k, wav2vec2_xlsr, ...
        return UpstreamConfig(name=name, dim=1024, n_layers=25, layer_idx=layer_idx)


@dataclass(frozen=True)
class VocoderConfig:
    """Vocoder selection (reference: config/model/base.yaml `vocoder:` block,
    lightning/utils/tool.py get_vocoder)."""
    model: str = "HifiGAN"    # "HifiGAN" | "MelGAN" | "GriffinLim"
    speaker: str = "universal"  # "universal" | "LJSpeech"


@dataclass(frozen=True)
class ModelConfig:
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    variance_predictor: VariancePredictorConfig = field(default_factory=VariancePredictorConfig)
    variance_embedding: VarianceEmbeddingConfig = field(default_factory=VarianceEmbeddingConfig)
    variance: VarianceConfig = field(default_factory=VarianceConfig)
    codebook: CodebookConfig = field(default_factory=CodebookConfig)
    upstream: UpstreamConfig = field(default_factory=UpstreamConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    max_seq_len: int = 1000
    multi_speaker: bool = True
    multi_lingual: bool = True
    n_languages: int = 100   # reference fixes language table at 100 entries
    speaker: SpeakerConfig = field(default_factory=SpeakerConfig)
    use_lang_id: bool = True   # NOLID kill-switch (reference: Define.py / fastspeech2m.py:98-101)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    # dtype policy: "float32" for parity, "bfloat16" for speed
    compute_dtype: str = "float32"
    # rematerialize FFT blocks in backward (jax.checkpoint): HBM <-> FLOPs;
    # the port raises NotImplementedError when it is set
    remat: bool = False


@dataclass(frozen=True)
class OptimConfig:
    """Adam + warmup/anneal schedule (reference: config/train/fscl.yaml:1-17,
    lightning/optimizer.py:5-15, lightning/scheduler.py:5-60)."""
    batch_size: int = 8
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warmup_step: int = 4000
    anneal_steps: Tuple[int, ...] = (30000, 40000, 50000)
    anneal_rate: float = 0.3
    scheduler: str = "sqrt"   # "sqrt" | "const"


@dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    total_step: int = 50000
    log_step: int = 100
    synth_step: int = 1000
    val_step: int = 1000
    save_step: int = 1000
    seed: int = 43
    # input-pipeline depth: batches collated and copied to the device ahead
    # of the step by a background thread (0 disables; train/trainer.py)
    prefetch: int = 2
    # optimizer steps per dispatch in the JAX package (a scan of k steps in
    # one program); the port runs k single steps, the same math, and keeps
    # the check that log/val/synth/save cadences are multiples of k
    steps_per_dispatch: int = 1
    # output locations (reference: config/train/*-output.yaml `path:` block)
    ckpt_path: Optional[str] = None
    log_path: Optional[str] = None
    result_path: Optional[str] = None


def train_config_from_yaml(paths) -> TrainConfig:
    """Merge one or more reference-style config/train/*.yaml overlays
    (main.py:351-357 merges multiple train configs in order)."""
    if isinstance(paths, str):
        paths = [paths]
    raw: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            overlay = yaml.safe_load(f) or {}
        for k, v in overlay.items():
            if isinstance(v, dict) and isinstance(raw.get(k), dict):
                raw[k].update(v)
            else:
                raw[k] = v
    o = raw.get("optimizer", {})
    optim = OptimConfig(
        batch_size=o.get("batch_size", 8),
        lr=o.get("lr", 1e-3),
        betas=tuple(o.get("betas", (0.9, 0.98))),
        eps=o.get("eps", 1e-9),
        weight_decay=o.get("weight_decay", 0.0),
        grad_clip_thresh=o.get("grad_clip_thresh", 1.0),
        grad_acc_step=o.get("grad_acc_step", 1),
        warmup_step=o.get("warm_up_step", o.get("warmup_step", 4000)),
        anneal_steps=tuple(o.get("anneal_steps", (30000, 40000, 50000))),
        anneal_rate=o.get("anneal_rate", 0.3),
        # reference tune configs put scheduler_type at the top level
        # (config/train/tune-500.yaml:1); the optimizer block wins if both
        scheduler=o.get("scheduler_type", raw.get("scheduler_type", "sqrt")),
    )
    # step counts: flat (this repo) or under a `step:` block (reference
    # config/train/fscl.yaml:11-17)
    step = raw.get("step", {}) or {}

    def s(key, default):
        return raw.get(key, step.get(key, default))

    paths = raw.get("path", {}) or {}
    return TrainConfig(
        optim=optim,
        total_step=s("total_step", 50000),
        log_step=s("log_step", 100),
        synth_step=s("synth_step", 1000),
        val_step=s("val_step", 1000),
        save_step=s("save_step", 1000),
        seed=raw.get("seed", 43),
        prefetch=raw.get("prefetch", 2),
        steps_per_dispatch=raw.get("steps_per_dispatch", 1),
        ckpt_path=paths.get("ckpt_path"),
        log_path=paths.get("log_path"),
        result_path=paths.get("result_path"),
    )


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(_as_tuple(i) for i in x)
    return x


def model_config_from_yaml(path: str) -> ModelConfig:
    """Load a reference-style config/model/*.yaml into a ModelConfig."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    t = raw.get("transformer", {})
    vp = raw.get("variance_predictor", {})
    ve = raw.get("variance_embedding", {})
    cfg = ModelConfig(
        transformer=TransformerConfig(
            encoder_layer=t.get("encoder_layer", 4),
            encoder_head=t.get("encoder_head", 2),
            encoder_hidden=t.get("encoder_hidden", 256),
            decoder_layer=t.get("decoder_layer", 6),
            decoder_head=t.get("decoder_head", 2),
            decoder_hidden=t.get("decoder_hidden", 256),
            conv_filter_size=t.get("conv_filter_size", 1024),
            conv_kernel_size=_as_tuple(t.get("conv_kernel_size", (9, 1))),
            encoder_dropout=t.get("encoder_dropout", 0.2),
            decoder_dropout=t.get("decoder_dropout", 0.2),
        ),
        variance_predictor=VariancePredictorConfig(
            filter_size=vp.get("filter_size", 256),
            kernel_size=vp.get("kernel_size", 3),
            dropout=vp.get("dropout", 0.5),
        ),
        variance_embedding=VarianceEmbeddingConfig(
            pitch_quantization=ve.get("pitch_quantization", "linear"),
            energy_quantization=ve.get("energy_quantization", "linear"),
            n_bins=ve.get("n_bins", 256),
        ),
        variance=VarianceConfig(
            pitch_feature=raw.get("pitch", {}).get("feature", "phoneme_level"),
            energy_feature=raw.get("energy", {}).get("feature", "phoneme_level"),
            pitch_normalization=raw.get("pitch", {}).get("normalization", True),
            energy_normalization=raw.get("energy", {}).get("normalization", True),
        ),
        max_seq_len=raw.get("max_seq_len", 1000),
        multi_speaker=raw.get("multi_speaker", True),
        multi_lingual=raw.get("multi_lingual", True),
    )
    # SSL upstream selection: `upstream: <name>` (Define.set_upstream) or a
    # dict with explicit dims for custom/tiny upstreams
    up = raw.get("upstream")
    if isinstance(up, str):
        cfg = replace(cfg, upstream=UpstreamConfig.from_name(
            up, raw.get("layer_idx")))
    elif isinstance(up, dict):
        cfg = replace(cfg, upstream=UpstreamConfig(
            name=up.get("name", "hubert_large_ll60k"),
            dim=up.get("dim", 1024),
            n_layers=up.get("n_layers", 25),
            layer_idx=up.get("layer_idx"),
            scan_layers=up.get("scan_layers", False),
            compute_dtype=up.get("compute_dtype", "float32")))
    # reference model YAMLs select the speaker path with a top-level
    # `speaker_emb` key (config/model/fscl-fastspeech2.yaml:44 "dvec")
    spk = raw.get("speaker", {})
    cfg = replace(cfg, speaker=SpeakerConfig(
        emb_type=raw.get("speaker_emb", spk.get("emb_type", "table")),
        n_speakers=spk.get("n_speakers", 1),
        n_ref_slices=spk.get("n_ref_slices", 10),
    ))
    # codebook: either this repo's `codebook: {size, nhead}` block or the
    # reference's top-level `codebook_size` + `downstream.transformer.nhead`
    # (config/model/fscl-fastspeech2.yaml:1-8)
    cb = raw.get("codebook", {})
    ds = (raw.get("downstream", {}) or {}).get("transformer",
                                               raw.get("downstream", {}) or {})
    if cb or "codebook_size" in raw:
        cfg = replace(cfg, codebook=CodebookConfig(
            size=cb.get("size", raw.get("codebook_size", 128)),
            num_heads=cb.get("nhead", cb.get("num_heads",
                                             ds.get("nhead", 4))),
            dim=cfg.transformer.encoder_hidden,
        ))
    voc = raw.get("vocoder", {}) or {}
    if voc:
        cfg = replace(cfg, vocoder=VocoderConfig(
            model=voc.get("model", "HifiGAN"),
            speaker=voc.get("speaker", "universal")))
    return cfg
