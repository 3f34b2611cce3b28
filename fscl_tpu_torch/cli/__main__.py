"""`python -m fscl_tpu_torch.cli <command> ...` with the commands preprocess,
make-units, train, tune, synth, evaluate, clean, pack and rehearse (port of
`fscl_tpu/cli/__main__.py`).

The subparsers take fscl_tpu's flags with its defaults (`:13-220`); those
that run a model add `--device` (default `cuda`, through
`core.device.resolve_device`: without a card it raises unless `--device cpu`
is passed). `evaluate`, `clean` and `pack` run on the host only. A flag the
port does not run yet raises when it is set to anything but its default,
naming the ROADMAP item that ports it. `rehearse --corpus_cache` defaults to
the port's own directory: its corpora are made by the port's preprocessing.
"""
from __future__ import annotations

import argparse
import os
import sys


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the kernels' "
                        "plain versions)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fscl_tpu_torch",
        description="few-shot cross-lingual TTS, PyTorch/CUDA port")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("preprocess", help="corpus -> feature store")
    p.add_argument("corpus_dir", nargs="?", default=None)
    p.add_argument("output_dir", nargs="?", default=None)
    p.add_argument("--preprocess_config", default=None,
                   help="config/preprocess/*.yaml bundle; supplies corpus_dir/output_dir/"
                        "parser defaults")
    p.add_argument("--parser", default=None,
                   help="raw parser tag (see fscl_tpu_torch.data.parsers)")
    p.add_argument("--textgrid_dir", default=None,
                   help="directory of MFA TextGrids (required for --preprocess)")
    p.add_argument("--parse_raw", action="store_true")
    p.add_argument("--prepare_mfa", default=None, metavar="MFA_DATA_DIR",
                   help="stage wav+txt pairs for the external `mfa align` CLI (prints the "
                        "exact command to run next)")
    p.add_argument("--preprocess", action="store_true")
    p.add_argument("--create_dataset", action="store_true")
    p.add_argument("--n_workers", type=int, default=4)
    p.add_argument("--pitch_method", default=None,
                   choices=["world", "yin", "yin_device", "world_device"],
                   help="override the preprocess YAML's preprocessing.pitch.method "
                        "(world = reference parity, host C++; world_device = the same DIO "
                        "algorithm batched on --device; yin_device = batched YIN there)")
    p.add_argument("--debug", action="store_true",
                   help="limit to 128 utterances (reference --debug)")
    _add_device(p)

    mu = sub.add_parser("make-units",
                        help="pseudo-unit discovery (k-means + DPDP) into ssl_units/<name>")
    mu.add_argument("features_dir")
    mu.add_argument("--unit_name", required=True)
    mu.add_argument("--n_units", type=int, default=64)
    mu.add_argument("--source", default="mel", help="mel (default) or an SSL upstream name")
    mu.add_argument("--seed", type=int, default=0)
    mu.add_argument("--limit", type=int, default=None)
    mu.add_argument("--layer", type=int, default=-1,
                    help="SSL hidden layer to cluster (hubert sources)")
    mu.add_argument("--upstream_ckpt", default=None,
                    help="upstream checkpoint for the SSL source: a released HF, fairseq "
                         "or s3prl file, or a state dict under the port's keys (random "
                         "weights from --seed without)")
    _add_device(mu)

    t = sub.add_parser("train", help="train a system")
    t.add_argument("--system", default="baseline",
                   help="registry key (baseline, baseline-tune, fscl, fscl-orig, tacot2u, "
                        "fscl-t2u, ...: the generic path builds any ported key)")
    t.add_argument("--data_config", action="append", required=True)
    t.add_argument("--model_config", default=None)
    t.add_argument("--train_config", action="append", default=None,
                   help="train yaml overlays (merged in order)")
    t.add_argument("--algorithm_config", default=None)
    t.add_argument("--exp_dir", default="output/exp")
    t.add_argument("--total_step", type=int, default=None)
    t.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="optimizer steps per dispatch (k single steps here; "
                        "log/val/save cadence must be multiples of k)")
    t.add_argument("--pretrain_ckpt", default=None)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--n_devices", type=int, default=None,
                   help="data-axis ranks: spawn n_devices x n_model ranks on this host, one "
                        "process each, that split every batch (gloo where ranks share a card)")
    t.add_argument("--upstream_parallel", choices=["none", "pp", "sp"], default="none",
                   help="shard the frozen SSL upstream over the model axis: pp = pipeline "
                        "stages of its layers, sp = sequence-parallel frames")
    t.add_argument("--n_model", type=int, default=None,
                   help="model-axis size (default 2 when --upstream_parallel is pp or sp)")
    t.add_argument("--debug", action="store_true",
                   help="print the model structure and cap the run to 2 steps "
                        "(reference main.py --debug)")
    t.add_argument("--use_tracker", action="store_true",
                   help="track the run under <exp_dir>/experiments/<exp_key> (local JSON: "
                        "meta.json, metrics.jsonl, assets/; the reference's Comet role)")
    t.add_argument("--exp_key", default=None,
                   help="experiment key to resume a tracked experiment under "
                        "(reference --exp_key)")
    t.add_argument("--distributed", action="store_true",
                   help="join a multi-process run started from outside, one process per rank "
                        "(FSCL_COORDINATOR / FSCL_NUM_PROCESSES / FSCL_PROCESS_ID, or "
                        "torchrun's environment); each process reads its own batch stream; "
                        "no-op for one process")
    _add_device(t)

    tu = sub.add_parser("tune", help="few-shot transfer to a new language")
    tu.add_argument("--data_config", required=True,
                    help="few-shot task config.yaml (task generation output)")
    tu.add_argument("--fscl_ckpt", default=None, help="pretrained FSCL checkpoint dir")
    tu.add_argument("--model_config", default=None)
    tu.add_argument("--exp_dir", default="output/tune")
    tu.add_argument("--adaptation_steps", type=int, default=20000)
    tu.add_argument("--scan_adapt", action="store_true",
                    help="run the whole adaptation on the device with no per-step host "
                         "wait and write the per-step loss curve to adaptation.csv")
    tu.add_argument("--scan_lr", type=float, default=1e-4,
                    help="learning rate for --scan_adapt")
    tu.add_argument("--scan_optimizer", choices=["sgd", "adam"], default="sgd",
                    help="--scan_adapt optimizer; adam matches the reference tune flows "
                         "(Adam beta=(0.9,0.98) + grad clip 1.0), with moments carried "
                         "across chunks")
    _add_device(tu)

    s = sub.add_parser("synth", help="synthesize from text")
    s.add_argument("--ckpt_dir", required=True)
    s.add_argument("--data_config", required=True)
    s.add_argument("--text", default=None, help="text or {PHONEME ...} string")
    s.add_argument("--text_file", default=None,
                   help="file with one utterance per line; batch serving over bucketed "
                        "synthesis. --output becomes a directory of NNNN.wav files")
    s.add_argument("--batch_size", type=int, default=8,
                   help="serving batch size for --text_file")
    s.add_argument("--speaker", type=int, default=0)
    s.add_argument("--model_config", default=None)
    s.add_argument("--ref_wav", default=None,
                   help="reference audio of the target speaker (required for speaker_emb "
                        "dvec/encoder models)")
    s.add_argument("--output", default="output.wav")
    s.add_argument("--vocoder_ckpt", default=None)
    s.add_argument("--stream", action="store_true",
                   help="chunked vocoding with receptive-field halos "
                        "(audio_out/streaming.py); HiFiGAN vocoder + --text only")
    s.add_argument("--chunk", type=int, default=64,
                   help="mel frames per streamed chunk (--stream)")
    _add_device(s)

    e = sub.add_parser("evaluate", help="PER/FER over task output dirs")
    e.add_argument("dir")
    e.add_argument("--metric", choices=["per", "fer", "both"], default="both")
    e.add_argument("--pl_filter", action="store_true",
                   help="pseudo-label confidence threshold sweep: `dir` is a feature-store "
                        "root; reads ssl_units/<unit_name>/{lp,alignment}_matrix")
    e.add_argument("--unit_name", default=None)
    e.add_argument("--thresholds", default="0.01,0.2,0.9,0.95")
    e.add_argument("--matrix", choices=["lp_matrix", "alignment_matrix"], default="lp_matrix")
    e.add_argument("--unify_map", default=None,
                   help="json with ref2unify/pred2unify symbol maps (shared-inventory "
                        "comparison)")

    c = sub.add_parser("clean", help="data validation / filtering")
    c.add_argument("data_dir")
    c.add_argument("--output", default=None)

    pk = sub.add_parser("pack", help="write packed training shards for a data config's "
                                     "splits (single-file native batch reads)")
    pk.add_argument("--data_config", required=True)
    pk.add_argument("--model_config", default=None)
    pk.add_argument("--splits", default="train")
    pk.add_argument("--fscl", action="store_true",
                    help="pack FSCL episodic shards (TTS features + raw 16 kHz wavs + "
                         "alignment) instead of supervised TTS shards")
    pk.add_argument("--stats", default=None,
                    help="global stats json for pitch/energy normalization (default: "
                         "built-in global stats, matching the training datamodule)")

    r = sub.add_parser(
        "rehearse",
        help="full-experiment rehearsal: corpus -> meta-train -> task generation -> "
             "transplant -> adaptation -> synthesis -> eval, timed per phase (rehearsal.json)")
    r.add_argument("--exp_dir", default="output/rehearsal")
    r.add_argument("--flow", choices=["fscl", "t2u", "pr"], default="fscl",
                   help="experiment family: fscl (TTS transfer), t2u (unit discovery -> u2s -> "
                        "fscl-t2u -> E2E chain), pr (episodic protonet -> task PER/FER)")
    r.add_argument("--n_units", type=int, default=12,
                   help="t2u flow: k-means pseudo-unit inventory size")
    r.add_argument("--u2s_steps", type=int, default=80,
                   help="t2u flow: unit-to-speech training steps")
    r.add_argument("--tune_steps", type=int, default=40,
                   help="t2u flow: E2E-chain fine-tuning steps")
    r.add_argument("--preset", choices=["tiny", "full"], default="tiny",
                   help="tiny: CPU-smoke sizes; full: reference scale (enc4/dec6 256d + "
                        "HuBERT-large in bf16)")
    r.add_argument("--episodes", type=int, default=40, help="meta-training episodes")
    r.add_argument("--adapt_steps", type=int, default=200,
                   help="test-time adaptation budget (reference: 20000)")
    r.add_argument("--shots", type=int, default=4)
    r.add_argument("--queries", type=int, default=2)
    r.add_argument("--corpus_utts", type=int, default=12,
                   help="utterances per synthetic corpus")
    r.add_argument("--corpus_cache",
                   default=os.path.join(os.path.expanduser("~"), ".cache", "fscl_tpu_torch",
                                        "corpora"),
                   help="persist synthetic corpora across rehearsal runs under a content-hash "
                        "key (generation params + source hash); '' disables")
    r.add_argument("--lr", type=float, default=1e-3)
    r.add_argument("--adapt_lr", type=float, default=1e-4)
    r.add_argument("--data_config", action="append", default=None,
                   help="meta-train corpora (repeatable); with --target, skips synthetic "
                        "corpus generation")
    r.add_argument("--target", default=None, help="held-out target-language data config")
    r.add_argument("--write_wavs", action="store_true",
                   help="also render the synthesized mels to wav via Griffin-Lim into "
                        "exp_dir/wavs/")
    _add_device(r)
    return parser


def main(argv=None):
    """Parse `argv` (default sys.argv[1:]) and run the subcommand; returns
    what the subcommand's `run` returns."""
    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.command == "preprocess":
        from fscl_tpu_torch.cli.preprocess_cmd import run
    elif args.command == "make-units":
        from fscl_tpu_torch.cli.make_units_cmd import run
    elif args.command == "train":
        from fscl_tpu_torch.cli.train_cmd import run
    elif args.command == "tune":
        from fscl_tpu_torch.cli.tune_cmd import run
    elif args.command == "evaluate":
        from fscl_tpu_torch.cli.evaluate_cmd import run
    elif args.command == "clean":
        from fscl_tpu_torch.cli.clean_cmd import run
    elif args.command == "pack":
        from fscl_tpu_torch.cli.pack_cmd import run
    elif args.command == "rehearse":
        from fscl_tpu_torch.cli.rehearse_cmd import run
    else:
        from fscl_tpu_torch.cli.synth_cmd import run
    return run(args)


if __name__ == "__main__":
    # `rehearse` returns its exit code (1 when an enforced quality gate
    # fails); the other commands return their results
    result = main()
    sys.exit(result if isinstance(result, int) else 0)
