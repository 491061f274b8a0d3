"""The kernel build's cache key (`ops/dispatch.py`): a library's name hashes
its source, the `csrc/*.cuh` headers the source includes and the flags, so
an edited header rebuilds every library that includes it. CPU only: the
names are computed, nothing is compiled."""

from __future__ import annotations

from heterofusionrcnn_torch.ops import conv, dispatch, grouping, nms, sampling, xconv
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
    """conv, convt and xconv share conv_common.cuh and their bf16 forms
    (conv_bf16.cuh; xconv_bf16.cuh): an edit of either renames (rebuilds)
    each library that includes it."""
    for kern in (conv.CONV_KERNEL, conv.CONVT_KERNEL, conv.CONV_BF16_KERNEL):
        assert [p.name for p in kern.headers()] == ["conv_bf16.cuh", "conv_common.cuh"]
    for kern in (xconv.XCONV_KERNEL, xconv.XCONV_BF16_KERNEL):
        assert [p.name for p in kern.headers()] == [
            "conv_bf16.cuh", "conv_common.cuh", "xconv_bf16.cuh"]
    assert grouping.KNN_KERNEL.headers() == []


def test_fps_and_nms_include_the_cluster_argmax_header():
    """FPS and NMS share the cluster argmax: an edit of its header renames
    (rebuilds) both libraries."""
    for kern in (sampling.FPS_KERNEL, nms.NMS_KERNEL):
        assert [p.name for p in kern.headers()] == ["cluster_argmax.cuh"]
    assert sampling.FPS_KERNEL.lib_path != nms.NMS_KERNEL.lib_path


def test_kernels_of_one_source_share_a_library_and_count_apart(tmp_path, monkeypatch):
    """The XConv and its split epilogue live in one source: one library, one
    nvcc process for both, a launch count each."""
    main = xconv.XCONV_KERNEL
    epi = xconv.XCONV_EPILOGUE_KERNEL
    assert main.lib_path == epi.lib_path and main.name != epi.name
    commands = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            commands.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(dispatch, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(dispatch, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(dispatch.subprocess, "Popen", Proc)
    dispatch.build_all([main, epi])
    assert len(commands) == 1 and main.lib_path.exists()
