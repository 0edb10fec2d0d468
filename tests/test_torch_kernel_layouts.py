"""What the port's K3 and K4 wrappers decide on the host before a launch,
checked on CPU tensors: the strides K3's TMA maps take (and the layouts it
refuses), and the dtype K4 reads its scale in.  Needs no card."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rms_kernel  # noqa: E402


def test_tma_strides_of_contiguous_and_fused_views():
    q = torch.zeros((2, 40, 4, 80), dtype=torch.bfloat16)
    assert flash_ops.tma_strides(q, "q") == (40 * 4 * 80, 4 * 80, 80)
    qkv = torch.zeros((2, 50, 3, 4, 32), dtype=torch.bfloat16)
    for t in qkv.unbind(2):
        assert flash_ops.tma_strides(t, "k") == (50 * 3 * 4 * 32, 3 * 4 * 32,
                                                 32)


def test_tma_strides_replace_the_stride_of_a_size_one_dim():
    base = torch.zeros(64 * 64, dtype=torch.bfloat16)
    t = base.as_strided((1, 8, 1, 64), (3, 128, 5, 1))
    assert flash_ops.tma_strides(t, "v") == (8 * 64, 128, 64)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(2 * 8 * 2 * 16 + 1,
                        dtype=torch.bfloat16)[1:].view(2, 8, 2, 16),
    lambda: torch.zeros((2, 8, 2, 20), dtype=torch.bfloat16)[..., :16],
    lambda: torch.zeros((2, 8, 12),
                        dtype=torch.bfloat16)[..., :8].unsqueeze(2)])
def test_tma_strides_refuse_unaligned_layouts(make):
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.tma_strides(make(), "q")


def test_flash_head_dims_take_80_and_refuse_48():
    assert 80 in flash_ops.HEAD_DIMS and 48 not in flash_ops.HEAD_DIMS


def test_rms_kernel_scale_dtype():
    x = torch.zeros((2, 8), dtype=torch.bfloat16)
    same = torch.ones(8, dtype=torch.bfloat16)
    assert rms_kernel.kernel_scale(x, same) is same
    wide = torch.ones(8, dtype=torch.float32)
    assert rms_kernel.kernel_scale(x, wide) is wide
    half = torch.ones(8, dtype=torch.float16)
    assert rms_kernel.kernel_scale(x, half).dtype == torch.float32
