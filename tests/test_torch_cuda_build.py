"""The build key of a CUDA source (ops/cuda_lib.py:source_digest) covers the
headers of `csrc/` it includes, so that editing csrc/hopper_attention.cuh
rebuilds both attention libraries, and csrc/hopper.cuh all three. No nvcc
needed: only the key."""
from fscl_tpu_torch.ops import cuda_lib


def _write(d, name, text):
    path = d / name
    path.write_text(text)
    return path


def test_a_changed_header_changes_the_digest(tmp_path):
    src = _write(tmp_path, "k.cu", '#include "a.cuh"\n#include <stdint.h>\nint f();\n')
    a = _write(tmp_path, "a.cuh", '#pragma once\n#include "b.cuh"\n')
    b = _write(tmp_path, "b.cuh", "#pragma once\nconstexpr int X = 1;\n")
    _write(tmp_path, "unused.cuh", "constexpr int Y = 1;\n")
    assert cuda_lib.local_headers(src) == [a, b]
    before = cuda_lib.source_digest(src)
    assert cuda_lib.source_digest(src) == before
    _write(tmp_path, "unused.cuh", "constexpr int Y = 2;\n")
    assert cuda_lib.source_digest(src) == before          # not included: no rebuild
    b.write_text("#pragma once\nconstexpr int X = 2;\n")
    changed = cuda_lib.source_digest(src)
    assert changed != before                              # included through a.cuh
    a.write_text('#pragma once\n#include "b.cuh"\n// edited\n')
    assert cuda_lib.source_digest(src) not in (before, changed)


def test_both_attention_sources_include_the_shared_header():
    """Both attention files include csrc/hopper_attention.cuh, and through it
    csrc/hopper.cuh, the Hopper helpers that the MRF stage includes too."""
    for name in ("attention", "attention_bwd"):
        headers = cuda_lib.local_headers(cuda_lib.CSRC_DIR / f"{name}.cu")
        assert [h.name for h in headers] == ["hopper_attention.cuh", "hopper.cuh"]
    headers = cuda_lib.local_headers(cuda_lib.CSRC_DIR / "mrf_stage.cu")
    assert [h.name for h in headers] == ["hopper.cuh"]


def test_a_source_without_headers_keeps_its_digest(tmp_path):
    """Without headers the key is the hash of the source and the flags, as
    before headers entered it: an unchanged source is not rebuilt."""
    import hashlib
    src = _write(tmp_path, "k.cu", "int f();\n")
    want = hashlib.sha256(src.read_bytes() + " ".join(cuda_lib.NVCC_FLAGS).encode()).hexdigest()
    assert cuda_lib.source_digest(src) == want[:16]
