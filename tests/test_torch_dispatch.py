"""The kernel build's cache key (`ops/dispatch.py`): a library's name hashes
its source, the `csrc/*.cuh` headers the source includes and the flags, so
an edited header rebuilds every library that includes it. CPU only: the
names are computed, nothing is compiled."""

from __future__ import annotations

from heterofusionrcnn_torch.ops import conv, grouping
from heterofusionrcnn_torch.ops.dispatch import CudaKernel


def _kernel(tmp_path, header_text):
    (tmp_path / "common.cuh").write_text(header_text)
    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n#include <cuda_runtime.h>\n')
    return CudaKernel(str(tmp_path / "k.cu"), {}, exact=False)


def test_header_edit_renames_library(tmp_path):
    before = _kernel(tmp_path, "// one\n").lib_path
    assert _kernel(tmp_path, "// one\n").lib_path == before
    after = _kernel(tmp_path, "// two\n").lib_path
    assert after != before and after.parent == before.parent


def test_nested_header_is_hashed(tmp_path):
    k = _kernel(tmp_path, '#include "inner.cuh"\n')
    assert [p.name for p in k.headers()] == ["common.cuh", "inner.cuh"]
    before = k.lib_path
    (tmp_path / "inner.cuh").write_text("// edited\n")
    assert k.lib_path != before


def test_conv_kernels_include_their_common_header():
    for kern in (conv.CONV_KERNEL, conv.CONVT_KERNEL):
        assert [p.name for p in kern.headers()] == ["conv_common.cuh"]
    assert grouping.KNN_KERNEL.headers() == []
