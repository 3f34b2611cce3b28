"""Frozen model and training configuration objects.

The port's own copy of the model and training halves of
`fscl_tpu/core/config.py` (`:25-200`, `train_config_from_yaml` at `:381-433`
and `model_config_from_yaml` at `:442-522`): the same frozen dataclasses,
defaults and YAML reading, so a `config/model/*.yaml` or `config/train/*.yaml`
file gives the same config in both packages; and the data, algorithm and
preprocess halves (`:203-379`, `:548-631`): `DataConfig`, `AlgorithmConfig`,
`PreprocessConfig`, their readers, `to_dict` and `to_json`. Every YAML under
`config/` gives equal `to_dict` in both packages (tests/test_torch_config_tree.py).
`t2u_config_from_yaml` (`:525`) reads the T2U family's `tacotron2:` block.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
    # rematerialize FFT blocks in backward (torch.utils.checkpoint): HBM <-> FLOPs
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


@dataclass(frozen=True)
class AdaptConfig:
    """Few-shot adaptation (reference: config/algorithm/language/fscl.yaml:33-48).

    Train episodes use (ways, shots, queries); the test block may override
    episode sizes (config/algorithm/phoneme_recognition/ssl-baseline.yaml:44-48).
    """
    ways: int = 1
    shots: int = 32
    queries: int = 8
    adaptation_lr: float = 1e-3
    adaptation_steps: int = 0
    test_adaptation_steps: int = 20000
    meta_batch_size: int = 1
    test_shots: Optional[int] = None
    test_queries: Optional[int] = None
    test_batch_size: Optional[int] = None


@dataclass(frozen=True)
class PhonemeEmbConfig:
    """Phoneme-embedding hub selection (reference: the `phoneme_emb` anchor in
    config/algorithm/**.yaml — `_phn_emb_config.{embedding,codebook}`)."""
    type: str = "embedding"          # "embedding" | "codebook"
    size: int = 128
    representation_dim: int = 1024
    attention: str = "soft-m"        # "hard" | "soft" | "soft-m"
    share: bool = False
    refresh: bool = False


@dataclass(frozen=True)
class AlgorithmConfig:
    type: str = "baseline"          # selects system + datamodule (registry key)
    name: str = "baseline"
    adapt: AdaptConfig = field(default_factory=AdaptConfig)
    # reference adapt-block extras (config/algorithm/language/fscl.yaml:17-31)
    adapt_type: str = "lang"            # "spk" | "lang"
    adapt_class: str = "MAML"           # "MAML" | "iMAML"
    speaker_emb: Optional[str] = None   # "shared"|"table"|"encoder"|"dvec"
    phoneme_emb: Optional[PhonemeEmbConfig] = None
    modules: Tuple[str, ...] = ()       # adapted module names
    # iMAML extras (config/algorithm/language/imaml.yaml `imaml:` block)
    imaml_cg_steps: int = 5
    imaml_reg_param: float = 1.0
    # set for reference algorithm types that upstream itself no longer
    # registers (commented out of lightning/systems/__init__.py) and that
    # have no equivalent system here; loaders keep them inspectable
    deprecated: bool = False
    extra: Tuple[Tuple[str, Any], ...] = ()

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.extra:
            if k == key:
                return v
        return default


@dataclass(frozen=True)
class DataConfig:
    """Per-dataset data-config bundle (reference: Objects/config.py:5-37).

    `symbol_id` selects the phoneme symbol table; `unit_name` selects an
    ssl_units pseudo-unit inventory for t2u targets.
    """
    name: str = ""
    lang_id: int = 0
    symbol_id: str = "en"
    data_dir: str = ""
    subsets: Tuple[Tuple[str, str], ...] = ()   # (split, txt path)
    text_cleaners: Tuple[str, ...] = ("english_cleaners",)
    unit_name: Optional[str] = None

    def subset_path(self, split: str) -> Optional[str]:
        for k, v in self.subsets:
            if k == split:
                return v
        return None


def read_data_config(path: str) -> DataConfig:
    """Read a per-dataset config.yaml bundle, inferring symbol_id like the
    reference's LanguageDataConfigReader (Objects/config.py:9-37)."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    root = os.path.dirname(os.path.abspath(path))
    subsets = tuple(
        (k, os.path.join(root, v)) for k, v in raw.get("subsets", {}).items()
    )
    lang_id = raw.get("lang_id", 0)
    symbol_id = raw.get("symbol_id")
    unit_name = None
    target = raw.get("target")
    if target is not None and "unit_name" in target:
        unit_name = target["unit_name"]
        symbol_id = symbol_id or unit_name
    if symbol_id is None:
        from fscl_tpu_torch.frontend.define import LANG_ID2NAME
        symbol_id = LANG_ID2NAME[lang_id]
    return DataConfig(
        name=raw.get("name", os.path.basename(root)),
        lang_id=lang_id,
        symbol_id=symbol_id,
        data_dir=raw.get("data_dir", root),
        subsets=subsets,
        text_cleaners=tuple(raw.get("text_cleaners", ["basic_cleaners"])),
        unit_name=unit_name,
    )


def read_algorithm_config(path: str) -> AlgorithmConfig:
    """Load a config/algorithm/*.yaml in either layout:

    - flat (this repo's native): ``adapt: {ways, shots, queries,
      adaptation_lr, adaptation_steps, test_adaptation_steps}``
    - reference-nested (config/algorithm/language/fscl.yaml:17-48):
      ``adapt: {type, class, speaker_emb, phoneme_emb, modules,
      task: {...}, train: {steps, meta_batch_size}, test: {steps, ...}}``
    """
    with open(path) as f:
        raw = yaml.safe_load(f)
    a = raw.get("adapt", {}) or {}
    task = a.get("task", {}) or {}
    tr = a.get("train", {}) or {}
    te = a.get("test", {}) or {}

    def pick(key, default):
        # train block > task anchor > flat adapt block > default
        return tr.get(key, task.get(key, a.get(key, default)))

    adapt = AdaptConfig(
        ways=pick("ways", 1),
        shots=pick("shots", 32),
        queries=pick("queries", 8),
        adaptation_lr=a.get("adaptation_lr",
                            tr.get("lr", task.get("lr", a.get("lr", 1e-3)))),
        adaptation_steps=a.get("adaptation_steps",
                               tr.get("steps", a.get("steps", 0))),
        test_adaptation_steps=a.get(
            "test_adaptation_steps", te.get("steps", 20000)),
        meta_batch_size=tr.get("meta_batch_size",
                               a.get("meta_batch_size", 1)),
        test_shots=te.get("shots") if te.get("shots") != task.get("shots")
        else None,
        test_queries=(te.get("queries")
                      if te.get("queries") != task.get("queries") else None),
        test_batch_size=te.get("batch_size"),
    )
    pe = a.get("phoneme_emb")
    phoneme_emb = None
    if isinstance(pe, dict):
        att = pe.get("attention", {}) or {}
        phoneme_emb = PhonemeEmbConfig(
            type=pe.get("type", "embedding"),
            size=pe.get("size", 128),
            representation_dim=pe.get("representation_dim", 1024),
            attention=att.get("type", "soft-m"),
            share=att.get("share", False),
            refresh=pe.get("refresh", False),
        )
    known = {"type", "name", "adapt", "deprecated", "_phn_emb_config"}
    extra = tuple((k, v) for k, v in raw.items() if k not in known
                  and not isinstance(v, (dict, list)))
    return AlgorithmConfig(
        type=raw.get("type", "baseline"),
        name=raw.get("name", raw.get("type", "baseline")),
        adapt=adapt,
        adapt_type=a.get("type", "lang"),
        adapt_class=a.get("class", "MAML"),
        speaker_emb=a.get("speaker_emb"),
        phoneme_emb=phoneme_emb,
        modules=tuple(a.get("modules", ()) or ()),
        imaml_cg_steps=(a.get("imaml", {}) or {}).get("K", 5),
        imaml_reg_param=(a.get("imaml", {}) or {}).get("reg_param", 1.0),
        deprecated=bool(raw.get("deprecated", False)),
        extra=extra,
    )


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


def t2u_config_from_yaml(path: str, n_units: int = 512):
    """The `tacotron2:` block of a reference-style model YAML as a
    T2UConfig (config/model/tacot2u.yaml, fscl-t2u.yaml; fscl-t2u-e2e.yaml
    nests it under `t2u:`); keys it does not set keep their defaults."""
    from fscl_tpu_torch.models.tacotron2_t2u import T2UConfig
    with open(path) as f:
        raw = yaml.safe_load(f)
    tc = raw.get("tacotron2") or (raw.get("t2u", {}) or {}).get("tacotron2", {}) or {}
    return T2UConfig(n_units=n_units, **{k: tc[k] for k in T2UConfig._fields
                                         if k in tc and k != "n_units"})


@dataclass(frozen=True)
class PreprocessConfig:
    """Per-corpus preprocessing bundle (reference:
    config/preprocess/*.yaml, e.g. CSS10-german.yaml:1-36)."""
    dataset: str = ""
    parser: str = ""                 # RAW_PARSERS registry key
    lang_id: int = 0
    corpus_path: str = ""
    raw_path: str = ""
    preprocessed_path: str = ""
    lexicon_path: Optional[str] = None
    subsets: Tuple[Tuple[str, str], ...] = ()   # (split, subset name)
    val_size: int = 512
    text_cleaners: Tuple[str, ...] = ("basic_cleaners",)
    text_language: str = "en"
    audio: AudioConfig = field(default_factory=AudioConfig)
    variance: VarianceConfig = field(default_factory=VarianceConfig)
    # "world" (DIO-style, the reference's pyworld role) or "yin"
    pitch_method: str = "world"


# corpus name -> RAW_PARSERS key (reference: Parsers/__init__.py:18-58).
# config/preprocess/*.yaml dataset ids like "CSS10-german" or "kss-4" route
# to the base corpus parser. VCTK/JVS/CV ship preprocess YAMLs upstream but
# have no raw parser there either (their registry lacks those keys).
DATASET2PARSER = {
    "LJSpeech": "LJSpeech", "LibriTTS": "LibriTTS",
    "AISHELL-3": "AISHELL-3", "kss": "KSS", "JSUT": "JSUT",
    "CSS10": "CSS10", "GlobalPhone": "GlobalPhone",
    "TAT": "TAT", "TATTTS": "TAT_TTS", "M-AILABS": "M-AILABS",
    "ALFFA": "ALFFA", "LAD": "LAD", "CSMSC": "CSMSC",
}


def read_preprocess_config(path: str) -> PreprocessConfig:
    """Load a reference-style config/preprocess/*.yaml."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    p = raw.get("path", {}) or {}
    pp = raw.get("preprocessing", {}) or {}
    audio_raw = pp.get("audio", {}) or {}
    stft = pp.get("stft", {}) or {}
    mel = pp.get("mel", {}) or {}
    text = pp.get("text", {}) or {}
    dataset = raw.get("dataset", "")
    # "CSS10-german" -> css10 parser; "kss-4" -> kss
    base = dataset.split("-")[0]
    parser = raw.get("parser") or DATASET2PARSER.get(
        dataset, DATASET2PARSER.get(base, base.lower()))
    mel_fmax = mel.get("mel_fmax", 8000.0)
    if mel_fmax is None:     # reference uses null for MelGAN compatibility
        mel_fmax = audio_raw.get("sampling_rate", 22050) / 2.0
    return PreprocessConfig(
        dataset=dataset,
        parser=parser,
        lang_id=raw.get("lang_id", 0),
        corpus_path=p.get("corpus_path", ""),
        raw_path=p.get("raw_path", ""),
        preprocessed_path=p.get("preprocessed_path", ""),
        lexicon_path=p.get("lexicon_path"),
        subsets=tuple((k, v) for k, v in (raw.get("subsets", {}) or {}).items()),
        val_size=pp.get("val_size", 512),
        text_cleaners=tuple(text.get("text_cleaners", ["basic_cleaners"])),
        text_language=text.get("language", "en"),
        audio=AudioConfig(
            sampling_rate=audio_raw.get("sampling_rate", 22050),
            n_fft=stft.get("filter_length", 1024),
            hop_length=stft.get("hop_length", 256),
            win_length=stft.get("win_length", 1024),
            n_mels=mel.get("n_mel_channels", 80),
            mel_fmin=float(mel.get("mel_fmin", 0.0) or 0.0),
            mel_fmax=float(mel_fmax),
        ),
        pitch_method=(pp.get("pitch", {}) or {}).get("method", "world"),
        variance=VarianceConfig(
            pitch_feature=(pp.get("pitch", {}) or {}).get(
                "feature", "phoneme_level"),
            energy_feature=(pp.get("energy", {}) or {}).get(
                "feature", "phoneme_level"),
            pitch_normalization=(pp.get("pitch", {}) or {}).get(
                "normalization", True),
            energy_normalization=(pp.get("energy", {}) or {}).get(
                "normalization", True),
        ),
    )


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def to_json(cfg) -> str:
    return json.dumps(to_dict(cfg), indent=2, default=str)
