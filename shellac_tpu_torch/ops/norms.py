"""RMSNorm / LayerNorm.

Ports `shellac_tpu/ops/norms.py`. `rms_norm_ref` and `layer_norm_ref` are
the plain PyTorch versions (fp32 statistics, output in x's dtype, the
`(1 + scale)` offset of the JAX package). `rms_norm` is the dispatch
point: a CUDA tensor goes to the hand-written kernel in
`csrc/rms_norm.cu` (through `RMSNormFunction` when autograd records the
call), a CPU tensor to the plain version.
"""

from __future__ import annotations

import torch

from shellac_tpu_torch.ops import _build


def rms_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 accumulation, output in x.dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


_KERNEL_DTYPES = {torch.float32: _build.DTYPE_F32,
                  torch.bfloat16: _build.DTYPE_BF16}


def rms_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm through the CUDA kernel (`csrc/rms_norm.cu`).

    x: (..., d) bf16 or fp32, contiguous, on a CUDA device; scale: (d,)
    fp32. Any d. Output in x's dtype. `rms_norm_cuda.launches` counts
    the kernel's launches.
    """
    if not x.is_cuda or not scale.is_cuda:
        raise ValueError("rms_norm_cuda needs CUDA tensors")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"rms_norm_cuda: x dtype {x.dtype} unsupported")
    if scale.dtype != torch.float32:
        raise ValueError("rms_norm_cuda: scale must be float32")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"rms_norm_cuda: scale {tuple(scale.shape)} != ({d},)")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rms_norm_cuda needs contiguous tensors")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    _build.launch(
        "shellac_rms_norm", x.data_ptr(), scale.data_ptr(), out.data_ptr(),
        rows, d, float(eps), _KERNEL_DTYPES[x.dtype],
    )
    rms_norm_cuda.launches += 1
    return out


rms_norm_cuda.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm with a kernel forward and a plain backward.

    The forward is `fwd(x, scale, eps)`: `rms_norm_cuda` on the card, or
    any function of the same contract (the tests inject `rms_norm_ref` to
    check the wiring on the CPU). The backward is autograd of
    `rms_norm_ref`, as the JAX package's `_rms_bwd` recomputes through
    its reference: there is no Pallas backward to port. Gradients reach x
    and the fp32 scale.
    """

    @staticmethod
    def forward(ctx, x, scale, eps, fwd):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        need_x, need_s = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            sd = scale.detach().requires_grad_(need_s)
            y = rms_norm_ref(xd, sd, ctx.eps)
            wrt = [t for t, need in ((xd, need_x), (sd, need_s)) if need]
            grads = list(torch.autograd.grad(y, wrt, g))
        dx = grads.pop(0) if need_x else None
        ds = grads.pop(0) if need_s else None
        return dx, ds, None, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Dispatching RMSNorm: the CUDA kernel on a CUDA tensor (under
    autograd through `RMSNormFunction`), the plain version on a CPU
    tensor."""
    if x.is_cuda:
        x = x.contiguous()
        if torch.is_grad_enabled() and (x.requires_grad
                                        or scale.requires_grad):
            return RMSNormFunction.apply(x, scale, eps, rms_norm_cuda)
        return rms_norm_cuda(x, scale, eps)
    if x.device.type != "cpu":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    return rms_norm_ref(x, scale, eps)
