"""CLI entry points (port of `fscl_tpu/cli`): preprocess, make-units, train, tune,
synth, evaluate, clean, pack and rehearse.

Usage: `python -m fscl_tpu_torch.cli <command> [...] [--device cpu]`, or
in process `fscl_tpu_torch.cli.main([...])`.
"""


def main(argv=None):
    """`fscl_tpu_torch.cli.__main__.main`, imported when called, so that
    `python -m fscl_tpu_torch.cli` does not import its own `__main__` twice."""
    from fscl_tpu_torch.cli.__main__ import main as _main
    return _main(argv)
