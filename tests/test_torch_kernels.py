"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `gpu`: each test skips in its body when no CUDA device is present
(the decision is made at run time, never at import, so every test worker
collects the same tests). On a card:

    python -m pytest -m gpu tests/test_torch_kernels.py

Tolerances: fp32 atol/rtol 2e-5 (summation order only); bf16 atol 2e-2
plus rtol 2e-2 (outputs are rounded to bf16, and attention rounds p to
bf16 before the p.V product).
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import pytest
import torch

from shellac_tpu_torch.ops import decode_attention as da
from shellac_tpu_torch.ops import flash_attention as fa
from shellac_tpu_torch.ops import norms

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _close(out, ref, dtype):
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


# The register-resident instances at d = 2048: one row (and decode's 8
# and 16) a CTA each; prefill's 1024 on either side of the few/many
# threshold (rows / 8 against the SM count in bf16, rows / 4 in fp32);
# prefill's 4096 and train's 12288 one warp a row (two in fp32). d = 128
# (q/k norms, 4096 tokens x 16 heads) at 16 threads a row (bf16) or 32
# (fp32). Every other width of whole 16-byte vectors takes them too, with
# a predicated tail where the width is not a multiple of the instance's
# span: MLA's 512, shellac-270m's 1024, shellac-7b's 4096, DeepSeek-V3's
# 7168, GPT-OSS-20B's 2880 (360 bf16 vectors over 64 threads a row) and
# 1000 (125 bf16 vectors over a warp), at decode's 8 and 16 rows, prefill's
# 4096 and train's 12288. 5 x 100 (not whole bf16 vectors) takes the
# generic body in bf16.
_RMS_WIDE = [(r, d) for d in (512, 1024, 4096, 7168, 1000)
             for r in (8, 16, 4096, 12288)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(4096, 2048), (8, 2048), (37, 1000),
                                    (5, 128), (1, 2048), (16, 2048),
                                    (1024, 2048), (1500, 2048),
                                    (12288, 2048), (65536, 128), (5, 100),
                                    (4096, 2880), (16, 2880)] + _RMS_WIDE)
def test_rms_norm_kernel(dtype, rows, d):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x = _randn(gen, (rows, d), dtype, dev)
    scale = 0.1 * _randn(gen, (d,), torch.float32, dev)
    before = norms.rms_norm_cuda.launches
    out = norms.rms_norm(x, scale, 1e-5)
    assert norms.rms_norm_cuda.launches == before + 1
    _close(out, norms.rms_norm_ref(x, scale, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_kernel_unaligned_rows(dtype):
    """A contiguous x whose base is not 16-byte aligned takes the generic
    body at d = 2048 and still matches."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(11)
    buf = _randn(gen, (16 * 2048 + 1,), dtype, dev)
    x = buf[1:].view(16, 2048)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = 0.1 * _randn(gen, (2048,), torch.float32, dev)
    _close(norms.rms_norm(x, scale, 1e-5),
           norms.rms_norm_ref(x, scale, 1e-5), dtype)


@pytest.mark.parametrize("rows", [8, 4096])
def test_rms_norm_kernel_is_deterministic(rows):
    """Calls and CUDA-graph replays give bitwise-equal results."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = _randn(gen, (rows, 2048), torch.bfloat16, dev)
    scale = 0.1 * _randn(gen, (2048,), torch.float32, dev)
    first = norms.rms_norm_cuda(x, scale)
    assert torch.equal(first, norms.rms_norm_cuda(x, scale))
    assert torch.equal(first, _replayed(lambda: norms.rms_norm_cuda(x, scale)))


def _replayed(fn, times=3):
    """fn captured once in a CUDA graph, replayed `times` times; every
    replay's output must equal the first's. Returns the output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    for _ in range(times - 1):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    return first


_FLASH = {
    "main_causal": dict(b=2, s=512, h=16, hkv=8, d=128, causal=True),
    "ragged_d64": dict(b=2, s=333, h=4, hkv=2, d=64, causal=True),
    "noncausal": dict(b=2, s=200, h=4, hkv=4, d=128, causal=False),
    "window_softcap_sinks": dict(b=2, s=300, h=4, hkv=2, d=128, causal=True,
                                 window=70, softcap=30.0, sinks=True),
    # The bf16 kernel's tile edges (128-row q and kv tiles): serve's B=1
    # admissions, a tail that is not a multiple of 128, windows of
    # exactly one tile and across tiles, GQA groups of 1 and 8, D 64
    # with softcap and sinks.
    "serve_b1_s1": dict(b=1, s=1, h=16, hkv=8, d=128, causal=True),
    "serve_b1_s64": dict(b=1, s=64, h=16, hkv=8, d=128, causal=True),
    "serve_b1_s1024": dict(b=1, s=1024, h=16, hkv=8, d=128, causal=True),
    "tail_s1000": dict(b=2, s=1000, h=4, hkv=2, d=128, causal=True),
    "window_one_tile": dict(b=1, s=640, h=4, hkv=2, d=128, causal=True,
                            window=128),
    "window_200": dict(b=1, s=700, h=4, hkv=2, d=128, causal=True,
                       window=200),
    "g1": dict(b=2, s=300, h=4, hkv=4, d=128, causal=True),
    "g8": dict(b=1, s=520, h=16, hkv=2, d=128, causal=True),
    "d64_softcap_sinks": dict(b=2, s=400, h=4, hkv=2, d=64, causal=True,
                              softcap=30.0, sinks=True),
    # GPT-OSS-20B's attention: 64 q heads over 8 kv heads of 64 with
    # sinks, the 128-token window and full layers, at generate's prefill
    # (8 x 512) and serve's largest admission (1 x 1024).
    "gptoss_window_sinks": dict(b=2, s=512, h=64, hkv=8, d=64, causal=True,
                                window=128, sinks=True),
    "gptoss_full_sinks": dict(b=2, s=512, h=64, hkv=8, d=64, causal=True,
                              sinks=True),
    "gptoss_b1_s1024_window_sinks": dict(b=1, s=1024, h=64, hkv=8, d=64,
                                         causal=True, window=128,
                                         sinks=True),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_FLASH))
def test_flash_attention_kernel(dtype, case):
    dev = _card()
    c = dict(_FLASH[case])
    b, s, h, hkv, d = (c.pop(k) for k in ("b", "s", "h", "hkv", "d"))
    gen = torch.Generator(device=dev).manual_seed(s)
    q = _randn(gen, (b, s, h, d), dtype, dev)
    k = _randn(gen, (b, s, hkv, d), dtype, dev)
    v = _randn(gen, (b, s, hkv, d), dtype, dev)
    if c.pop("sinks", False):
        c["sinks"] = _randn(gen, (h,), torch.float32, dev)
    before = fa.flash_attention_cuda.launches
    out = fa.flash_attention(q, k, v, **c)
    assert fa.flash_attention_cuda.launches == before + 1
    _close(out, fa.flash_attention_ref(q, k, v, **c), dtype)


# (s, h, hkv, L, d, extra). B 4 at lengths 0, 37, L // 2 + 3 and L - s
# unless "b" and "index" say otherwise. Past the first three, the bf16
# split-K body's edges (32-position tiles dealt round robin to the CTAs
# of a cluster of up to 8 per (slot, kv head), 4 warps each); generate's
# shape is B 8, s 1, H 16, Hkv 8, D 128, L 2048.
_DECODE = {
    "main_s1": dict(s=1, h=16, hkv=8, L=2048, d=128),
    "s4_d64": dict(s=4, h=8, hkv=4, L=300, d=64),
    "window_softcap_sinks": dict(s=1, h=16, hkv=8, L=1000, d=128,
                                 window=100, softcap=30.0, sinks=True),
    "b1_shorter_than_a_tile": dict(s=1, h=16, hkv=8, L=2048, d=128, b=1,
                                   index=[5]),
    "b16_ragged": dict(s=1, h=16, hkv=8, L=2048, d=128, b=16,
                       index=[0, 1, 31, 32, 33, 255, 256, 257, 300, 511,
                              512, 999, 1023, 1500, 2046, 2047]),
    "index_0": dict(s=1, h=16, hkv=8, L=2048, d=128, b=2, index=[0, 0]),
    "tiles_not_a_multiple_of_split": dict(s=1, h=16, hkv=8, L=2048, d=128,
                                          b=3, index=[8 * 32 * 2 + 17,
                                                      5 * 32 + 3, 289]),
    "index_plus_s_is_L": dict(s=1, h=16, hkv=8, L=2048, d=128,
                              index=[2047] * 4),
    "window_across_splits": dict(s=1, h=16, hkv=8, L=2048, d=128,
                                 index=[700, 129, 2047, 64], window=200),
    "softcap_sinks": dict(s=1, h=16, hkv=8, L=2048, d=128, b=8,
                          index=[128, 200, 333, 400, 450, 500, 550, 576],
                          softcap=30.0, sinks=True),
    "s4": dict(s=4, h=16, hkv=8, L=2048, d=128, index=[0, 300, 1000, 2044]),
    "g8_16_rows": dict(s=2, h=16, hkv=2, L=1024, d=128, b=2,
                       index=[17, 1022]),
    "d64": dict(s=1, h=16, hkv=8, L=2048, d=64, index=[3, 250, 1337, 2047]),
    "d64_g8_window_sinks": dict(s=2, h=16, hkv=2, L=777, d=64, b=2,
                                index=[400, 775], window=97, softcap=20.0,
                                sinks=True),
    # GPT-OSS-20B's decode at generate's B 8: window 128 and full, sinks.
    "gptoss_window_sinks": dict(s=1, h=64, hkv=8, L=2048, d=64, b=8,
                                index=[128, 200, 333, 400, 450, 500, 550,
                                       576], window=128, sinks=True),
    "gptoss_full_sinks": dict(s=1, h=64, hkv=8, L=2048, d=64, b=8,
                              index=[0, 127, 128, 129, 700, 1500, 2000,
                                     2047], sinks=True),
}


def _decode_inputs(case, dtype, dev):
    """q, the caches, index and the keyword arguments of a _DECODE case."""
    c = dict(_DECODE[case])
    s, h, hkv, L, d = (c.pop(k) for k in ("s", "h", "hkv", "L", "d"))
    b = c.pop("b", 4)
    index = c.pop("index", [0, 37, L // 2 + 3, L - s])
    gen = torch.Generator(device=dev).manual_seed(L)
    q = _randn(gen, (b, s, h, d), dtype, dev)
    ck = _randn(gen, (b, hkv, L, d), dtype, dev)
    cv = _randn(gen, (b, hkv, L, d), dtype, dev)
    idx = torch.tensor(index, dtype=torch.int32, device=dev)
    if c.pop("sinks", False):
        c["sinks"] = _randn(gen, (h,), torch.float32, dev)
    return q, ck, cv, idx, c


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_DECODE))
def test_decode_attention_kernel(dtype, case):
    dev = _card()
    q, ck, cv, index, c = _decode_inputs(case, dtype, dev)
    before = da.decode_attention_cuda.launches
    out = da.decode_attention(q, ck, cv, index, **c)
    assert da.decode_attention_cuda.launches == before + 1
    ref = da._decode_ref(q, ck, cv, index, c.get("window"),
                         q.shape[-1] ** -0.5, softcap=c.get("softcap"),
                         sinks=c.get("sinks"))
    _close(out, ref, dtype)


@pytest.mark.parametrize("case", ["b16_ragged", "window_across_splits",
                                  "g8_16_rows", "d64_g8_window_sinks"])
def test_decode_kernel_reads_only_the_live_range_across_splits(case):
    """NaN past each slot's length and before its window's first position,
    over lengths that span many tiles and every CTA of a cluster, must
    not reach the output."""
    dev = _card()
    q, ck, cv, idx, c = _decode_inputs(case, torch.bfloat16, dev)
    s, window = q.shape[1], c.get("window")
    out1 = da.decode_attention(q, ck, cv, idx, **c)
    for bi, n in enumerate(idx.tolist()):
        ck[bi, :, n + s:] = float("nan")
        cv[bi, :, n + s:] = float("nan")
        if window is not None:
            lo = max(n - window + 1, 0)
            ck[bi, :, :lo] = float("nan")
            cv[bi, :, :lo] = float("nan")
    out2 = da.decode_attention(q, ck, cv, idx, **c)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)


@pytest.mark.parametrize("case", ["b16_ragged", "softcap_sinks", "s4"])
def test_decode_kernel_is_deterministic(case):
    """The cluster merge has no counter or atomics to reset: calls and
    CUDA-graph replays give bitwise-equal bf16 results."""
    dev = _card()
    q, ck, cv, idx, c = _decode_inputs(case, torch.bfloat16, dev)
    first = da.decode_attention_cuda(q, ck, cv, idx, **c)
    assert torch.equal(first, da.decode_attention_cuda(q, ck, cv, idx, **c))
    assert torch.equal(first, _replayed(
        lambda: da.decode_attention_cuda(q, ck, cv, idx, **c)))


def test_decode_kernel_reads_nothing_past_length():
    """Poison past each slot's length must not reach the output."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _randn(gen, (2, 1, 8, 128), torch.bfloat16, dev)
    ck = _randn(gen, (2, 4, 256, 128), torch.bfloat16, dev)
    cv = _randn(gen, (2, 4, 256, 128), torch.bfloat16, dev)
    index = torch.tensor([10, 130], dtype=torch.int32, device=dev)
    out1 = da.decode_attention(q, ck, cv, index)
    for bi, n in enumerate((11, 131)):
        ck[bi, :, n:] = float("nan")
        cv[bi, :, n:] = float("nan")
    out2 = da.decode_attention(q, ck, cv, index)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.zeros(2, 16, 4, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)
    # The bf16 forward's TMA maps need 16-byte-aligned base addresses: a
    # contiguous view two bytes into its storage is refused.
    buf = torch.zeros(2 * 16 * 4 * 128 + 1, device=dev, dtype=torch.bfloat16)
    qm = buf[1:].view(2, 16, 4, 128)
    assert qm.is_contiguous() and qm.data_ptr() % 16 != 0
    kv = torch.zeros(2, 16, 4, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(qm, kv, kv)
    # So do the backward kernels' maps of q, k, v and dout.
    lse = torch.zeros(2, 4, 16, device=dev)
    for bwd in (fa.flash_bwd_dkdv_cuda, fa.flash_bwd_dq_cuda):
        for args in ((qm, kv, kv, kv), (kv, qm, kv, kv), (kv, kv, kv, qm)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                bwd(*args, lse, lse)
    h = torch.zeros(4, 8, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        norms.rms_norm(h, torch.zeros(8, device=dev))
    q = torch.zeros(1, 1, 32, 128, device=dev, dtype=torch.bfloat16)
    c = torch.zeros(1, 1, 64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rows per kv head"):
        da.decode_attention(q, c, c, torch.zeros(1, dtype=torch.int32,
                                                 device=dev))


def _paged_pool(gen, dtype, dev, index, s, hkv, bs, d, max_blocks,
                unowned=5, window=None):
    """A shuffled pool holding each slot's pages for positions
    [0, index + s), the rest of each table row at block 0. Returns
    (clean k, clean v, tables, poisoned k, poisoned v): the poisoned
    copies hold NaN in block 0, in every unowned block, in the rows of
    each slot's last page past its length and, with a window, in the
    rows before each slot's first live position."""
    need = [-(-(int(i) + s) // bs) for i in index.tolist()]
    n_blocks = 1 + sum(need) + unowned
    ids = torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(
        n_blocks)) + 1
    tables = torch.zeros((len(need), max_blocks), dtype=torch.int32)
    owned, at = [], 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[at:at + n]
        owned += ids[at:at + n].tolist()
        at += n
    k = _randn(gen, (n_blocks, hkv, bs, d), dtype, dev)
    v = _randn(gen, (n_blocks, hkv, bs, d), dtype, dev)
    dead = torch.ones((n_blocks, bs), dtype=torch.bool)
    for b, i in enumerate(index.tolist()):
        lo = 0 if window is None else max(i - window + 1, 0)
        pos = torch.arange(lo, i + s)
        dead[tables[b, pos // bs].long(), pos % bs] = False
    pk, pv = k.clone(), v.clone()
    rows = dead[:, None, :].expand(n_blocks, hkv, bs).to(dev)
    pk[rows] = float("nan")
    pv[rows] = float("nan")
    return k, v, tables.to(dev), pk, pv


# (s, h, hkv, d, bs, extra). Slots at lengths 0, 37, 643, 1279, 1100 and
# 15 of a 1280-position table unless "index" and "max_len" say otherwise.
# Past the first seven, the bf16 split-K body's edges (32-position tiles
# of the live range dealt round robin to the warps of a cluster of CTAs
# per (slot, kv head), one bulk copy per page segment of a tile);
# serve's shape is 16 slots, s 1, H 16, Hkv 8, D 128, bs 16, table 2048.
_SERVE_LENGTHS = [64, 1152, 300, 777, 1000, 90, 513, 640, 1100, 200, 129,
                  1023, 450, 880, 70, 999]
_PAGED = {
    "serve_bs16": dict(s=1, h=16, hkv=8, d=128, bs=16),
    "bs8": dict(s=1, h=16, hkv=8, d=128, bs=8),
    "bs32_d64": dict(s=1, h=8, hkv=4, d=64, bs=32),
    "bs64": dict(s=1, h=16, hkv=8, d=128, bs=64),
    "bs5_odd": dict(s=1, h=4, hkv=2, d=128, bs=5),
    "s4": dict(s=4, h=8, hkv=4, d=128, bs=16),
    "window_softcap_sinks": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                 window=100, softcap=30.0, sinks=True),
    "serve_16_ragged": dict(s=1, h=16, hkv=8, d=128, bs=16, max_len=2048,
                            index=_SERVE_LENGTHS),
    "full_capacity": dict(s=1, h=16, hkv=8, d=128, bs=16, max_len=2048,
                          index=[2047] * 4),
    "index_0": dict(s=1, h=16, hkv=8, d=128, bs=16, max_len=2048,
                    index=[0, 0]),
    "shorter_than_a_tile": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                max_len=2048, index=[5]),
    "tiles_not_a_multiple_of_split": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                          max_len=2048,
                                          index=[529, 163, 289]),
    # The first live position mid-page (700 - 199 = 501 = 31 * 16 + 5):
    # every full tile covers 3 pages, across the cluster's CTAs.
    "window_mid_page_across_splits": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                          max_len=2048,
                                          index=[700, 129, 2047, 64],
                                          window=200),
    "bs1": dict(s=1, h=16, hkv=8, d=128, bs=1, max_len=512,
                index=[0, 31, 200, 511]),
    "bs128": dict(s=1, h=16, hkv=8, d=128, bs=128, max_len=2048,
                  index=[5, 127, 1000, 2047]),
    "max_blocks_4096_few_live": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                     max_len=4096 * 16,
                                     index=[5, 100, 33, 300]),
    "g8_16_rows": dict(s=2, h=16, hkv=2, d=128, bs=16, max_len=2048,
                       index=[17, 2046]),
    "s4_d64": dict(s=4, h=8, hkv=4, d=64, bs=16, max_len=2048,
                   index=[0, 300, 1000, 2044]),
    # GPT-OSS-20B's decode at serve's 16 slots: window 128 and full,
    # sinks.
    "gptoss_serve_window_sinks": dict(s=1, h=64, hkv=8, d=64, bs=16,
                                      max_len=2048, index=_SERVE_LENGTHS,
                                      window=128, sinks=True),
    "gptoss_serve_full_sinks": dict(s=1, h=64, hkv=8, d=64, bs=16,
                                    max_len=2048, index=_SERVE_LENGTHS,
                                    sinks=True),
}


def _paged_inputs(case, dtype, dev):
    """q, the clean and poisoned pools, tables, index and the keyword
    arguments of a _PAGED case."""
    c = dict(_PAGED[case])
    s, h, hkv, d, bs = (c.pop(k) for k in ("s", "h", "hkv", "d", "bs"))
    max_len = c.pop("max_len", 1280)
    index = torch.tensor(c.pop("index", [0, 37, 640 + 3, max_len - s, 1100,
                                         15]), dtype=torch.int32)
    gen = torch.Generator(device=dev).manual_seed(bs * d + s)
    mb = -(-max_len // bs)
    k, v, tables, pk, pv = _paged_pool(gen, dtype, dev, index, s, hkv, bs,
                                       d, mb, window=c.get("window"))
    q = _randn(gen, (len(index), s, h, d), dtype, dev)
    if c.pop("sinks", False):
        c["sinks"] = _randn(gen, (h,), torch.float32, dev)
    return q, k, v, tables, index.to(dev), pk, pv, c


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_PAGED))
def test_paged_decode_attention_kernel(dtype, case):
    """Against the plain version on the clean pool; the kernel reads the
    NaN-poisoned copy, so it must never touch a dead or unowned page, or
    a row past a slot's length or before its window. An idle slot (length
    0, table row all 0) attends block 0 alone."""
    dev = _card()
    q, k, v, tables, index, pk, pv, c = _paged_inputs(case, dtype, dev)
    d = q.shape[-1]
    before = da.paged_decode_attention_cuda.launches
    out = da.paged_decode_attention(q, pk, pv, tables, index, **c)
    assert da.paged_decode_attention_cuda.launches == before + 1
    ref = da._paged_decode_ref(q, k, v, tables, index, c.get("window"),
                               d ** -0.5, softcap=c.get("softcap"),
                               sinks=c.get("sinks"))
    _close(out, ref, dtype)
    # The idle slot: length 0 over a zero row, poisoned block 0 aside.
    idle_t = torch.zeros_like(tables[:1])
    idle_i = torch.zeros_like(index[:1])
    out0 = da.paged_decode_attention(q[:1], k, v, idle_t, idle_i, **c)
    _close(out0, da._paged_decode_ref(q[:1], k, v, idle_t, idle_i,
                                      c.get("window"), d ** -0.5,
                                      softcap=c.get("softcap"),
                                      sinks=c.get("sinks")), dtype)


@pytest.mark.parametrize("case", ["serve_16_ragged",
                                  "window_mid_page_across_splits", "bs1",
                                  "g8_16_rows"])
def test_paged_kernel_is_deterministic(case):
    """The cluster merge has no counter or atomics to reset: calls and
    CUDA-graph replays of the bf16 and int8 paged kernels give
    bitwise-equal results."""
    dev = _card()
    q, _, _, tables, index, pk, pv, c = _paged_inputs(case, torch.bfloat16,
                                                      dev)
    first = da.paged_decode_attention_cuda(q, pk, pv, tables, index, **c)
    assert torch.equal(first, da.paged_decode_attention_cuda(
        q, pk, pv, tables, index, **c))
    assert torch.equal(first, _replayed(
        lambda: da.paged_decode_attention_cuda(q, pk, pv, tables, index,
                                               **c)))
    k8, ks = _quant_rows(torch.Generator(device=dev).manual_seed(3),
                         tuple(pk.shape), dev)
    v8, vs = _quant_rows(torch.Generator(device=dev).manual_seed(4),
                         tuple(pk.shape), dev)
    first = da.paged_decode_attention_quant_cuda(q, k8, v8, ks, vs, tables,
                                                 index, **c)
    assert torch.equal(first, da.paged_decode_attention_quant_cuda(
        q, k8, v8, ks, vs, tables, index, **c))
    assert torch.equal(first, _replayed(
        lambda: da.paged_decode_attention_quant_cuda(
            q, k8, v8, ks, vs, tables, index, **c)))


def test_paged_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    bf = torch.bfloat16
    q = torch.zeros(2, 1, 16, 128, device=dev, dtype=bf)
    pool = torch.zeros(9, 8, 16, 128, device=dev, dtype=bf)
    tab = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    ok = da.paged_decode_attention(q, pool, pool, tab, idx)
    torch.cuda.synchronize()
    assert torch.isfinite(ok.float()).all()
    bad = {
        "head_dim": (q[..., :96].contiguous(), pool[..., :96].contiguous(),
                     tab, idx),
        "rows per kv head": (torch.zeros(2, 9, 16, 128, device=dev,
                                         dtype=bf), pool, tab, idx),
        "int32": (q, pool, tab.long(), idx),
        "contiguous": (q, pool, tab.t().contiguous().t(), idx),
        "fp32 or bf16": (q.half(), pool.half(), tab, idx),
    }
    for match, (qq, pp, tt, ii) in bad.items():
        with pytest.raises(ValueError, match=match):
            da.paged_decode_attention(qq, pp, pp, tt, ii)
    # Scales over a bf16 pool: the int8 kernel takes int8 pools only.
    sc = pool[..., 0].float().contiguous()
    with pytest.raises(ValueError, match="int8"):
        da.paged_decode_attention(q, pool, pool, tab, idx, k_scale=sc,
                                  v_scale=sc)


# ---------------------------------------------------------- int8 caches
#
# The int8 kernels keep the dequantized logits and p in fp32, where the
# plain versions dequantize to q's dtype and round p to it: within the
# same bf16 tolerance.


def _quant_rows(gen, shape, dev):
    """Seeded normals (..., D) quantized as a cache write would: int8
    values and fp32 scales of shape[:-1]."""
    from shellac_tpu_torch.inference.cache import quantize_kv

    q, s = quantize_kv(torch.randn(shape, generator=gen, device=dev)[None])
    return q[0].contiguous(), s[0].contiguous()


# Today's cases (b 4, index [0, 37, L / 2 + 3, L - s]), then kernel 5's
# split-K edges over an int8 cache (_DECODE's shapes and lengths).
_DECODE_Q = {
    "main_s1": dict(s=1, h=16, hkv=8, L=2048, d=128),
    "s1_d64": dict(s=1, h=16, hkv=8, L=700, d=64),
    "s8_g2_rows16": dict(s=8, h=4, hkv=2, L=300, d=128),
    "s4_d64_g4": dict(s=4, h=8, hkv=2, L=300, d=64),
    "window_softcap_sinks": dict(s=2, h=16, hkv=8, L=1000, d=128,
                                 window=100, softcap=30.0, sinks=True),
    **{f"split_{name}": _DECODE[name] for name in (
        "b1_shorter_than_a_tile", "b16_ragged", "index_0",
        "tiles_not_a_multiple_of_split", "index_plus_s_is_L",
        "window_across_splits", "s4", "g8_16_rows", "d64",
        "d64_g8_window_sinks")},
}


def _decode_q_inputs(case, dtype, dev):
    """q, the int8 caches and their scales, index and the keyword
    arguments of a _DECODE_Q case."""
    c = dict(_DECODE_Q[case])
    s, h, hkv, L, d = (c.pop(k) for k in ("s", "h", "hkv", "L", "d"))
    b = c.pop("b", 4)
    index = c.pop("index", [0, 37, L // 2 + 3, L - s])
    gen = torch.Generator(device=dev).manual_seed(L + d + s)
    q = _randn(gen, (b, s, h, d), dtype, dev)
    ck, ks = _quant_rows(gen, (b, hkv, L, d), dev)
    cv, vs = _quant_rows(gen, (b, hkv, L, d), dev)
    index = torch.tensor(index, dtype=torch.int32, device=dev)
    if c.pop("sinks", False):
        c["sinks"] = _randn(gen, (h,), torch.float32, dev)
    return q, ck, cv, ks, vs, index, c


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_DECODE_Q))
def test_decode_attention_quant_kernel(dtype, case):
    dev = _card()
    q, ck, cv, ks, vs, index, c = _decode_q_inputs(case, dtype, dev)
    s, d = q.shape[1], q.shape[3]
    before = (da.decode_attention_quant_cuda.launches,
              da.decode_attention_cuda.launches)
    out = da.decode_attention(q, ck, cv, index, k_scale=ks, v_scale=vs, **c)
    assert (da.decode_attention_quant_cuda.launches,
            da.decode_attention_cuda.launches) == (before[0] + 1, before[1])
    ref = da._decode_ref(q, ck, cv, index, c.get("window"), d ** -0.5,
                         softcap=c.get("softcap"), sinks=c.get("sinks"),
                         k_scale=ks, v_scale=vs)
    _close(out, ref, dtype)
    # Only each slot's live range is read: NaN scales past its length and
    # before its window's first position change nothing.
    window = c.get("window")
    for bi, n in enumerate(index.tolist()):
        ks[bi, :, n + s:] = float("nan")
        vs[bi, :, n + s:] = float("nan")
        if window is not None:
            lo = max(n - window + 1, 0)
            ks[bi, :, :lo] = float("nan")
            vs[bi, :, :lo] = float("nan")
    again = da.decode_attention(q, ck, cv, index, k_scale=ks, v_scale=vs,
                                **c)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.parametrize("case", ["split_b16_ragged", "window_softcap_sinks",
                                  "split_s4", "split_g8_16_rows"])
def test_decode_quant_kernel_is_deterministic(case):
    """Kernel 6 on the split-K body: calls and CUDA-graph replays give
    bitwise-equal bf16 results (nothing to reset between them)."""
    dev = _card()
    q, ck, cv, ks, vs, idx, c = _decode_q_inputs(case, torch.bfloat16, dev)

    def call():
        return da.decode_attention_quant_cuda(q, ck, cv, ks, vs, idx, **c)

    first = call()
    assert torch.equal(first, call())
    assert torch.equal(first, _replayed(call))


# The int8 cases: today's (serve-int8's bs 64 first), then the split-K
# body's edges as in _PAGED, over int8 pools.
_PAGED_Q = {
    "serve_bs64": dict(s=1, h=16, hkv=8, d=128, bs=64),
    "bs16": dict(s=1, h=16, hkv=8, d=128, bs=16),
    "bs32_d64": dict(s=1, h=8, hkv=4, d=64, bs=32),
    "s4_bs32": dict(s=4, h=8, hkv=4, d=128, bs=32),
    "window_softcap_sinks": dict(s=1, h=16, hkv=8, d=128, bs=64,
                                 window=100, softcap=30.0, sinks=True),
    "serve_16_ragged": dict(s=1, h=16, hkv=8, d=128, bs=64, max_len=2048,
                            index=_SERVE_LENGTHS),
    "full_capacity": dict(s=1, h=16, hkv=8, d=128, bs=64, max_len=2048,
                          index=[2047] * 4),
    "index_0": dict(s=1, h=16, hkv=8, d=128, bs=64, max_len=2048,
                    index=[0, 0]),
    "shorter_than_a_tile": dict(s=1, h=16, hkv=8, d=128, bs=64,
                                max_len=2048, index=[5]),
    "tiles_not_a_multiple_of_split": dict(s=1, h=16, hkv=8, d=128, bs=64,
                                          max_len=2048,
                                          index=[529, 163, 289]),
    "window_mid_page_across_splits": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                          max_len=2048,
                                          index=[700, 129, 2047, 64],
                                          window=200),
    "bs1": dict(s=1, h=16, hkv=8, d=128, bs=1, max_len=512,
                index=[0, 31, 200, 511]),
    "bs128": dict(s=1, h=16, hkv=8, d=128, bs=128, max_len=2048,
                  index=[5, 127, 1000, 2047]),
    "max_blocks_4096_few_live": dict(s=1, h=16, hkv=8, d=128, bs=16,
                                     max_len=4096 * 16,
                                     index=[5, 100, 33, 300]),
    "g8_16_rows": dict(s=2, h=16, hkv=2, d=128, bs=64, max_len=2048,
                       index=[17, 2046]),
    "s4_d64": dict(s=4, h=8, hkv=4, d=64, bs=64, max_len=2048,
                   index=[0, 300, 1000, 2044]),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_PAGED_Q))
def test_paged_decode_attention_quant_kernel(dtype, case):
    """Against the plain version on the clean pool; the kernel reads a
    copy whose block 0, unowned blocks, rows past each slot's length and
    rows before its window hold NaN scales, so it must never touch a dead
    or unowned page or a row outside the live range."""
    dev = _card()
    c = dict(_PAGED_Q[case])
    s, h, hkv, d, bs = (c.pop(k) for k in ("s", "h", "hkv", "d", "bs"))
    gen = torch.Generator(device=dev).manual_seed(bs * d + s + 1)
    max_len = c.pop("max_len", 1280)
    index = torch.tensor(c.pop("index", [0, 37, 640 + 3, max_len - s, 1100,
                                         15]), dtype=torch.int32)
    mb = -(-max_len // bs)
    _, _, tables, pk, _ = _paged_pool(gen, torch.float32, dev, index, s,
                                      hkv, bs, d, mb, window=c.get("window"))
    dead = torch.isnan(pk[..., 0])
    k, ksc = _quant_rows(gen, pk.shape, dev)
    v, vsc = _quant_rows(gen, pk.shape, dev)
    pks, pvs = ksc.clone(), vsc.clone()
    pks[dead] = float("nan")
    pvs[dead] = float("nan")
    index = index.to(dev)
    q = _randn(gen, (len(index), s, h, d), dtype, dev)
    if c.pop("sinks", False):
        c["sinks"] = _randn(gen, (h,), torch.float32, dev)
    before = (da.paged_decode_attention_quant_cuda.launches,
              da.paged_decode_attention_cuda.launches)
    out = da.paged_decode_attention(q, k, v, tables, index, k_scale=pks,
                                    v_scale=pvs, **c)
    assert (da.paged_decode_attention_quant_cuda.launches,
            da.paged_decode_attention_cuda.launches) == (before[0] + 1,
                                                         before[1])
    kw = dict(softcap=c.get("softcap"), sinks=c.get("sinks"))
    ref = da._paged_decode_ref(q, k, v, tables, index, c.get("window"),
                               d ** -0.5, k_scale=ksc, v_scale=vsc, **kw)
    _close(out, ref, dtype)
    # The idle slot (length 0, table row all 0) over zeroed scales, as
    # init_quant_paged_cache leaves block 0: a zero output, no NaN.
    idle_t = torch.zeros_like(tables[:1])
    idle_i = torch.zeros_like(index[:1])
    zs = torch.zeros_like(ksc)
    out0 = da.paged_decode_attention(q[:1], k, v, idle_t, idle_i, k_scale=zs,
                                     v_scale=zs, **c)
    _close(out0, da._paged_decode_ref(q[:1], k, v, idle_t, idle_i,
                                      c.get("window"), d ** -0.5,
                                      k_scale=zs, v_scale=zs, **kw), dtype)


def test_quant_wrappers_raise_on_what_the_kernels_do_not_take():
    dev = _card()
    bf = torch.bfloat16
    q = torch.zeros(2, 1, 16, 128, device=dev, dtype=bf)
    c8 = torch.zeros(2, 8, 64, 128, device=dev, dtype=torch.int8)
    sc = torch.ones(2, 8, 64, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    pool = torch.zeros(9, 8, 16, 128, device=dev, dtype=torch.int8)
    psc = torch.ones(9, 8, 16, device=dev)
    tab = torch.zeros(2, 4, dtype=torch.int32, device=dev)
    ok = da.decode_attention(q, c8, c8, idx, k_scale=sc, v_scale=sc)
    ok2 = da.paged_decode_attention(q, pool, pool, tab, idx, k_scale=psc,
                                    v_scale=psc)
    torch.cuda.synchronize()
    assert torch.isfinite(ok.float()).all()
    assert torch.isfinite(ok2.float()).all()
    dense_bad = {
        "int8": (q, c8.to(bf), sc, sc),
        "head_dim": (q[..., :96].contiguous(), c8[..., :96].contiguous(),
                     sc, sc),
        "fp32": (q, c8, sc.to(bf), sc.to(bf)),
        r"\(2, 8, 64\)": (q, c8, sc[..., :32].contiguous(),
                            sc[..., :32].contiguous()),
        "fp32 or bf16": (q.half(), c8, sc, sc),
        "rows per kv head": (torch.zeros(2, 9, 16, 128, device=dev,
                                         dtype=bf), c8, sc, sc),
    }
    for match, (qq, cc, ss, vv) in dense_bad.items():
        with pytest.raises(ValueError, match=match):
            da.decode_attention(qq, cc, cc, idx, k_scale=ss, v_scale=vv)
    paged_bad = {
        "int8": (q[..., :64].contiguous(), pool[..., :64].to(bf)),
        "head_dim": (q[..., :96].contiguous(), pool[..., :96].contiguous()),
    }
    for match, (qq, pp) in paged_bad.items():
        with pytest.raises(ValueError, match=match):
            da.paged_decode_attention(qq, pp, pp, tab, idx, k_scale=psc,
                                      v_scale=psc)
    with pytest.raises(ValueError, match="come together"):
        da.decode_attention(q, c8, c8, idx, k_scale=sc)
    with pytest.raises(ValueError, match="come together"):
        da.paged_decode_attention(q, pool, pool, tab, idx, v_scale=psc)
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        da.decode_attention(qg, c8, c8, idx, k_scale=sc, v_scale=sc)
    with pytest.raises(RuntimeError, match="inference-only"):
        da.paged_decode_attention(qg, pool, pool, tab, idx, k_scale=psc,
                                  v_scale=psc)


# ---------------------------------------------------------- training path

# Held to the plain versions relative to each output's scale: |out - ref|
# <= atol * max|ref| + rtol * |ref|. The backward kernels sum many
# products of bf16-rounded p and ds, so bf16 is judged against the scale.
_BWD = {
    "causal_gqa": dict(b=2, s=256, h=8, hkv=4, d=128, causal=True),
    "ragged_d64": dict(b=2, s=333, h=4, hkv=2, d=64, causal=True),
    "noncausal": dict(b=1, s=200, h=4, hkv=4, d=128, causal=False),
    "segments_odd": dict(b=2, s=301, h=4, hkv=2, d=128, causal=True,
                         bounds=(0, 77, 149, 150, 301)),
    "window_softcap_sinks": dict(b=2, s=300, h=4, hkv=2, d=128, causal=True,
                                 window=70, softcap=30.0, sinks=True),
    # Tile edges of the bf16 forward (128-row tiles), whose lse the
    # backward kernels read: B=1 at S=2048, a 1000-row tail, segment
    # boundaries inside tiles with whole tiles of one document between
    # them, GQA groups of 1 and 8, D 64 with softcap and sinks, and
    # windows of one tile and across tiles.
    "b1_s2048": dict(b=1, s=2048, h=4, hkv=2, d=128, causal=True),
    "tail_s1000": dict(b=1, s=1000, h=4, hkv=2, d=128, causal=True),
    "segments_in_tiles": dict(b=2, s=1000, h=4, hkv=2, d=128, causal=True,
                              bounds=(0, 50, 130, 131, 300, 1000)),
    "segments_noncausal": dict(b=1, s=700, h=4, hkv=4, d=64, causal=False,
                               bounds=(0, 200, 456, 700)),
    "g1": dict(b=1, s=300, h=4, hkv=4, d=128, causal=True),
    "g8": dict(b=1, s=520, h=16, hkv=2, d=128, causal=True),
    "d64_softcap_sinks": dict(b=2, s=400, h=4, hkv=2, d=64, causal=True,
                              softcap=30.0, sinks=True),
    "window_one_tile": dict(b=1, s=640, h=4, hkv=2, d=128, causal=True,
                            window=128),
    "window_200": dict(b=1, s=700, h=4, hkv=2, d=128, causal=True,
                       window=200),
    # The backward's own edges (128-row work tiles, 64-row streamed
    # tiles): S one past a tile, a ragged tail inside one consumer's half.
    "s129": dict(b=1, s=129, h=4, hkv=2, d=128, causal=True),
    "s1000_d64_segments": dict(b=1, s=1000, h=8, hkv=1, d=64, causal=True,
                               bounds=(0, 64, 100, 1000)),
}


def _scaled_close(out, ref, dtype, what="", scale=None):
    """out within atol of ref's largest magnitude (or of `scale`, given
    for a reference that is exactly zero) plus rtol of ref."""
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all(), what
    bound = atol * (ref.abs().max() if scale is None else scale) \
        + rtol * ref.abs()
    err = (out - ref).abs()
    assert (err <= bound).all(), (what, err.max().item())


def _bwd_case(case, dtype, dev):
    c = dict(_BWD[case])
    b, s, h, hkv, d = (c.pop(k) for k in ("b", "s", "h", "hkv", "d"))
    gen = torch.Generator(device=dev).manual_seed(s + d)
    q = _randn(gen, (b, s, h, d), dtype, dev)
    k = _randn(gen, (b, s, hkv, d), dtype, dev)
    v = _randn(gen, (b, s, hkv, d), dtype, dev)
    do = _randn(gen, (b, s, h, d), dtype, dev)
    bounds = c.pop("bounds", None)
    seg = None
    if bounds is not None:
        seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for i in range(len(bounds) - 1):
            seg[:, bounds[i]:bounds[i + 1]] = i
    sinks = _randn(gen, (h,), torch.float32, dev) if c.pop("sinks", False) \
        else None
    return q, k, v, do, seg, sinks, c


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_BWD))
def test_flash_forward_lse_and_segments(dtype, case):
    dev = _card()
    q, k, v, _, seg, sinks, c = _bwd_case(case, dtype, dev)
    out, lse = fa.flash_attention_cuda(q, k, v, sinks=sinks, segments=seg,
                                       with_lse=True, **c)
    rout, rlse = fa.flash_forward_ref(q, k, v, sinks=sinks, segments=seg,
                                      **c)
    _close(out, rout, dtype)
    _close(lse, rlse, torch.float32 if dtype == torch.float32 else dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_BWD))
def test_flash_backward_kernels(dtype, case):
    dev = _card()
    q, k, v, do, seg, sinks, c = _bwd_case(case, dtype, dev)
    out, lse = fa.flash_forward_ref(q, k, v, sinks=sinks, segments=seg, **c)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         out.float()).contiguous()
    before = (fa.flash_bwd_dkdv_cuda.launches, fa.flash_bwd_dq_cuda.launches)
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta, segments=seg,
                                    **c)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, segments=seg, **c)
    assert (fa.flash_bwd_dkdv_cuda.launches,
            fa.flash_bwd_dq_cuda.launches) == (before[0] + 1, before[1] + 1)
    rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, lse, delta, segments=seg,
                                     **c)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, lse, delta, segments=seg, **c)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.dtype == dtype
        _scaled_close(got, ref, dtype, name)


@pytest.mark.parametrize("case", ["causal_gqa", "segments_in_tiles", "g8",
                                  "window_softcap_sinks"])
def test_flash_backward_is_deterministic(case):
    """Every dk/dv and dq tile is written by one block with no atomics:
    two calls on the same inputs give bitwise-equal bf16 results."""
    dev = _card()
    q, k, v, do, seg, sinks, c = _bwd_case(case, torch.bfloat16, dev)
    _, lse = fa.flash_forward_ref(q, k, v, sinks=sinks, segments=seg, **c)
    delta = torch.randn(lse.shape, device=dev)
    runs = []
    for _ in range(2):
        dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta,
                                        segments=seg, **c)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, segments=seg,
                                  **c)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["causal_gqa", "window_softcap_sinks",
                                  "segments_odd"])
def test_flash_function_grads_match_autograd(dtype, case):
    """The kernels' (dq, dk, dv, dsinks) against autograd through the
    plain attention on the same card."""
    dev = _card()
    q, k, v, do, seg, sinks, c = _bwd_case(case, dtype, dev)
    leaves = [q, k, v] + ([sinks] if sinks is not None else [])
    ins = [t.detach().clone().requires_grad_() for t in leaves]
    ref_ins = [t.detach().clone().requires_grad_() for t in leaves]
    sk = ins[3] if sinks is not None else None
    rsk = ref_ins[3] if sinks is not None else None
    out = fa.flash_attention(*ins[:3], sinks=sk, segments=seg, **c)
    ref = fa.flash_attention_ref(*ref_ins[:3], sinks=rsk, segments=seg, **c)
    got = torch.autograd.grad(out, ins, do)
    want = torch.autograd.grad(ref, ref_ins, do)
    for name, g, w in zip(("dq", "dk", "dv", "dsinks"), got, want):
        _scaled_close(g, w, dtype, name)


def test_gradients_reach_every_parameter_through_the_kernels():
    """The autograd fault repaired: a model step on the card (flash and
    RMSNorm kernels, forward and backward) gives every parameter the
    gradient the CPU's plain path gives, in fp32."""
    from shellac_tpu_torch.models import transformer as tt
    from shellac_tpu_torch.models.registry import get_model_config
    from shellac_tpu_torch.training import cross_entropy, named_leaves

    dev = _card()
    cfg = get_model_config("tiny-gqa").replace(
        dtype="float32", d_model=256, n_heads=4, n_kv_heads=2, remat=True)
    cpu_params = tt.init_params(cfg, seed=0, device="cpu", master=True)
    gen = torch.Generator().manual_seed(1)
    for lp in cpu_params["layers"]:
        for k in ("attn_norm", "mlp_norm"):
            lp[k] += 0.3 * torch.randn(lp[k].shape, generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 97), generator=gen)
    seg = torch.zeros((2, 96), dtype=torch.int32)
    seg[:, 40:] = 1
    grads = {}
    for where in ("cpu", "cuda"):
        params = _to(cpu_params, where)
        leaves = [p.requires_grad_() for _, p in named_leaves(params)]
        before = (norms.rms_norm_cuda.launches,
                  fa.flash_bwd_dkdv_cuda.launches,
                  fa.flash_bwd_dq_cuda.launches)
        logits = tt.forward(cfg, params, toks[:, :-1].to(where),
                            segment_ids=seg.to(where), device=where)
        loss, _ = cross_entropy(logits, toks[:, 1:].to(where))
        grads[where] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        if where == "cuda":
            after = (norms.rms_norm_cuda.launches,
                     fa.flash_bwd_dkdv_cuda.launches,
                     fa.flash_bwd_dq_cuda.launches)
            assert after[1] - before[1] == cfg.n_layers
            assert after[2] - before[2] == cfg.n_layers
            assert after[0] - before[0] == 4 * cfg.n_layers + 1
    names = [path for path, _ in named_leaves(cpu_params)]
    for path, g_cpu, g_card in zip(names, grads["cpu"], grads["cuda"]):
        assert g_card.abs().max() > 0, path
        torch.testing.assert_close(g_card, g_cpu, atol=1e-5 * float(
            g_cpu.abs().max()), rtol=1e-4, msg=str(path))


def _to(params, where):
    from shellac_tpu_torch.training.train_state import map_tree

    return map_tree(lambda t: t.detach().to(where).clone(), params)


def test_decode_wrappers_raise_under_grad():
    dev = _card()
    q = torch.zeros(1, 1, 16, 128, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    c = torch.zeros(1, 8, 64, 128, device=dev, dtype=torch.bfloat16)
    idx = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="inference-only"):
        da.decode_attention(q, c, c, idx)
    pool = torch.zeros(5, 8, 16, 128, device=dev, dtype=torch.bfloat16)
    tab = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="inference-only"):
        da.paged_decode_attention(q, pool, pool, tab, idx)
    with torch.no_grad():
        da.decode_attention(q, c, c, idx)


@pytest.mark.parametrize("tied", [False, True])
def test_lm_head_on_tensor_cores_matches_the_fp32_product(tied):
    """The bf16 LM head on the card (`LMHeadFunction`: the forward from
    bf16 operands with an fp32 result, the backward products in TF32)
    against the fp32 products it replaces, at shellac-1b's width. The
    forward multiplies the same bf16 values exactly and sums in fp32:
    1e-4 of the largest logit. The backward rounds the fp32 cotangent to
    TF32 (2^-11 relative) and its outputs to bf16 (2^-8): 1e-2 of the
    largest gradient. The TF32 switch is restored afterwards. A tied
    head's w is the embedding transposed; its gradient keeps that
    layout."""
    from shellac_tpu_torch.models.transformer import LMHeadFunction

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _randn(gen, (512, 2048), torch.bfloat16, dev).requires_grad_()
    w = (0.02 * torch.randn((2048, 32768), generator=gen, device=dev)).to(
        torch.bfloat16)
    if tied:
        w = w.t().contiguous().t()
    w.requires_grad_()
    g = torch.randn((512, 32768), generator=gen, device=dev) * 1e-3
    before = torch.backends.cuda.matmul.allow_tf32
    logits = LMHeadFunction.apply(x, w)
    dx, dw = torch.autograd.grad(logits, (x, w), g)
    assert torch.backends.cuda.matmul.allow_tf32 == before
    torch.backends.cuda.matmul.allow_tf32 = False
    xf, wf = x.detach().float(), w.detach().float()
    want = xf @ wf
    assert logits.dtype == torch.float32
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert dw.stride() == w.stride()
    for got, ref, atol in ((logits, want, 1e-4),
                           (dx, (g @ wf.t()).bfloat16(), 1e-2),
                           (dw, (xf.t() @ g).bfloat16(), 1e-2)):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max()
        assert err <= atol * ref.float().abs().max(), err.item()


# The beam search's shapes (K beams of one 512-token prompt): kernels 5
# and 6 over a beam cache of 1024 positions (the bucket of 512 + 64), rows
# 0 and 1 equal as after a reorder and one beam rolled back; kernel 7 over
# copy-on-write tables (the prompt's sealed blocks shared by every live
# row, row 1 sharing row 0's sealed generated blocks, the frozen rows'
# tables all block 0) at lengths on both sides of a block boundary.
# case -> (block size (None: dense), lengths, frozen rows).
_BEAM = {
    "dense_k4": (None, [575, 575, 575, 540], ()),
    "dense_k16": (None, [560] * 12 + [530, 560, 513, 560], ()),
    "paged_k4_cow": (16, [528, 528, 527, 520], (3,)),
    "paged_k16_cow": (16, [543, 543, 544, 544] * 3 + [544, 520, 544, 543],
                      (13,)),
    "paged_int8_k4_cow": (64, [576, 576, 575, 540], (3,)),
}


def _cow_tables(bs, lengths, frozen, prompt=512, max_len=2048):
    """(tables, n_blocks, dead (n_blocks, bs) rows no beam attends) of a
    copy-on-write beam search before a step (queries at `lengths`)."""
    k, sealed = len(lengths), prompt // bs
    need = [-(-(n + 1) // bs) for n in lengths]
    n_blocks = 2 + sealed + sum(need) + 8
    ids = (torch.randperm(n_blocks - 1,
                          generator=torch.Generator().manual_seed(bs)) + 1)
    tables = torch.zeros((k, max_len // bs), dtype=torch.int32)
    at = sealed
    for b in range(k):
        if b in frozen:
            continue
        tables[b, :sealed] = ids[:sealed]
        for j in range(sealed, need[b]):
            if b == 1 and j < min(need[0], need[1]) - 1:
                tables[1, j] = tables[0, j]
            else:
                tables[b, j] = ids[at]
                at += 1
    dead = torch.ones((n_blocks, bs), dtype=torch.bool)
    for b, n in enumerate(lengths):
        pos = torch.arange(n + 1)
        dead[tables[b, pos // bs].long(), pos % bs] = False
    return tables, n_blocks, dead


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_BEAM))
def test_decode_kernels_at_the_beam_shapes(dtype, case):
    dev = _card()
    bs, lengths, frozen = _BEAM[case]
    k, h, hkv, d = len(lengths), 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(k + (bs or 0))
    q = _randn(gen, (k, 1, h, d), dtype, dev)
    idx = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    if bs is None:
        ck = _randn(gen, (k, hkv, 1024, d), dtype, dev)
        cv = _randn(gen, (k, hkv, 1024, d), dtype, dev)
        ck[1], cv[1] = ck[0], cv[0]
        _close(da.decode_attention(q, ck, cv, idx),
               da._decode_ref(q, ck, cv, idx, None, scale), dtype)
        qk, sk = _quant_rows(gen, (k, hkv, 1024, d), dev)
        qv, sv = _quant_rows(gen, (k, hkv, 1024, d), dev)
        before = da.decode_attention_quant_cuda.launches
        out = da.decode_attention(q, qk, qv, idx, k_scale=sk, v_scale=sv)
        assert da.decode_attention_quant_cuda.launches == before + 1
        _close(out, da._decode_ref(q, qk, qv, idx, None, scale, k_scale=sk,
                                   v_scale=sv), dtype)
        return
    tables, nb, dead = _cow_tables(bs, lengths, frozen)
    tables = tables.to(dev)
    rows = dead[:, None, :].expand(nb, hkv, bs).to(dev)
    if bs == 64:
        pk, sk = _quant_rows(gen, (nb, hkv, bs, d), dev)
        pv, sv = _quant_rows(gen, (nb, hkv, bs, d), dev)
        out = da.paged_decode_attention(
            q, pk, pv, tables, idx, k_scale=sk.masked_fill(rows, float("nan")),
            v_scale=sv.masked_fill(rows, float("nan")))
        ref = da._paged_decode_ref(q, pk, pv, tables, idx, None, scale,
                                   k_scale=sk, v_scale=sv)
    else:
        pk = _randn(gen, (nb, hkv, bs, d), dtype, dev)
        pv = _randn(gen, (nb, hkv, bs, d), dtype, dev)
        out = da.paged_decode_attention(
            q, pk.masked_fill(rows[..., None], float("nan")),
            pv.masked_fill(rows[..., None], float("nan")), tables, idx)
        ref = da._paged_decode_ref(q, pk, pv, tables, idx, None, scale)
    _close(out, ref, dtype)


# --------------------------------------------------------------------------
# MLA's widths: the absorbed decode at D 576, the expanded prefill at 192
# --------------------------------------------------------------------------

# shellac-mla-2b's and DeepSeek-V2-Lite's attention: 16 q heads against
# ONE latent row a token, 576 wide (kv_lora_rank 512 + rope 64), with the
# same array as k and v; DeepSeek-V2/V3's 128 heads (8 CTAs of 16 rows a
# slot), and rows that leave the last CTA part full (24 heads at s 2).
# Lengths ragged from 0, across a tile and past one CTA's share of a
# cluster (a split of up to 8 x 32-position tiles), to the table's end;
# live counts (index + 1) at one and two tiles +-1 ("tile_edges"). One
# slot of a few positions leaves all but one CTA of its cluster without a
# tile ("b1_short"). Pools of blocks smaller than the tile (16, 8, 1): a
# tile is copied row by row, each row's page from the table. The wide
# body takes only the latent: two arrays, or a window, softcap or sinks,
# are refused ("refused").
_MLA_LENGTHS = [0, 1, 31, 32, 300, 511, 1023, 2047]
_MLA_TILE_EDGES = [30, 31, 32, 62, 63, 64, 95, 2046]
_MLA = {
    "dense_same": dict(paged=False, same=True),
    "dense_two_arrays": dict(paged=False, same=False, refused=True),
    "dense_b1_short": dict(paged=False, same=True, index=[5]),
    "dense_tile_edges": dict(paged=False, same=True, index=_MLA_TILE_EDGES),
    "paged_tile_edges_bs16": dict(paged=True, same=True, bs=16,
                                  index=_MLA_TILE_EDGES),
    "paged_b1_short_bs16": dict(paged=True, same=True, bs=16, index=[5]),
    "paged_same_bs8": dict(paged=True, same=True, bs=8),
    "paged_same_bs1": dict(paged=True, same=True, bs=1,
                           index=[0, 31, 33, 300]),
    "dense_window_softcap_sinks": dict(paged=False, same=True, window=300,
                                       softcap=30.0, sinks=True,
                                       refused=True),
    "dense_128_heads": dict(paged=False, same=True, heads=128),
    "dense_24_heads_s2": dict(paged=False, same=True, heads=24, s=2,
                              index=[0, 1, 31, 300, 1022, 2046]),
    "paged_same_bs16": dict(paged=True, same=True, bs=16),
    "paged_same_bs64": dict(paged=True, same=True, bs=64),
    "paged_128_heads_bs64": dict(paged=True, same=True, bs=64, heads=128),
    "paged_two_arrays_bs32": dict(paged=True, same=False, bs=32,
                                  refused=True),
    "paged_window_mid_page": dict(paged=True, same=True, bs=16, window=200,
                                  index=[700, 129, 2047, 64], refused=True),
}


def _mla_inputs(case, dtype, dev, quant=False):
    """q (B, s, heads, 576) (s 1 and 16 heads unless the case says), the
    latent cache (dense (B, 1, 2048, 576) or a paged pool, NaN on every
    row no slot attends), its v (the same tensor or another), index,
    and the call's keyword arguments; int8 with one scale a row (`quant`,
    shared by k and v when `same`). Returns (args, kwargs, plain_args):
    the kernel call's positional args and the plain version's on the
    clean storage."""
    c = dict(_MLA[case])
    paged, same = c.pop("paged"), c.pop("same")
    c.pop("refused", None)
    heads, s = c.pop("heads", 16), c.pop("s", 1)
    index = torch.tensor(c.pop("index", _MLA_LENGTHS), dtype=torch.int32)
    b, L, d = len(index), 2048, 576
    gen = torch.Generator(device=dev).manual_seed(len(case) + 576)
    q = _randn(gen, (b, s, heads, d), dtype, dev)
    if c.pop("sinks", False):
        c["sinks"] = _randn(gen, (heads,), torch.float32, dev)
    c["scale"] = 192 ** -0.5
    if paged:
        bs = c.pop("bs")
        k, v, tables, pk, pv = _paged_pool(gen, dtype, dev, index, s, 1, bs,
                                           d, L // bs, window=c.get("window"))
        if same:
            v, pv = k, pk
        store, poisoned = (k, v), (pk, pv)
        extra = (tables,)
    else:
        k = _randn(gen, (b, 1, L, d), dtype, dev)
        v = k if same else _randn(gen, (b, 1, L, d), dtype, dev)
        pos = torch.arange(L, device=dev)[None, :]
        lo = (index.to(dev)[:, None] - c["window"] + 1
              if "window" in c else torch.zeros_like(pos))
        dead = ((pos >= index.to(dev)[:, None] + s)
                | (pos < lo))[:, None, :, None]
        pk = k.masked_fill(dead, float("nan"))
        pv = pk if same else v.masked_fill(dead, float("nan"))
        store, poisoned = (k, v), (pk, pv)
        extra = ()
    idx = index.to(dev)
    if not quant:
        return (q, *poisoned, *extra, idx), c, (q, *store, *extra, idx)
    from shellac_tpu_torch.inference.cache import quantize_kv

    def quantized(x):
        xq, xs = quantize_kv(x.float()[None])
        return xq[0].contiguous(), xs[0].contiguous()

    kq, ks = quantized(store[0])
    vq, vs = (kq, ks) if same else quantized(store[1])
    # The kernel reads the same values with NaN scales on the dead rows.
    pks = torch.where(torch.isnan(poisoned[0][..., 0].float()),
                      float("nan"), ks)
    pvs = pks if same else torch.where(
        torch.isnan(poisoned[1][..., 0].float()), float("nan"), vs)
    c.update(k_scale=pks, v_scale=pvs)
    plain = dict(k_scale=ks, v_scale=vs)
    return (q, kq, vq, *extra, idx), c, ((q, kq, vq, *extra, idx), plain)


def _mla_plain(args, c, plain_scales=None):
    """The plain decode (dense or through the pool) on the clean inputs."""
    kw = dict(window=c.get("window"), scale=c["scale"],
              softcap=c.get("softcap"), sinks=c.get("sinks"),
              **(plain_scales or {}))
    if len(args) == 5:
        return da._paged_decode_ref(*args, **kw)
    return da._decode_ref(*args, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_MLA))
def test_mla_decode_at_576(dtype, case):
    """Kernels 5 and 7 at D 576 (the wide body) against their plain
    versions on clean storage: one launch of the dense or paged wrapper,
    which reads storage poisoned with NaN everywhere no slot attends. A
    refused case raises and launches nothing."""
    dev = _card()
    args, c, plain = _mla_inputs(case, dtype, dev)
    wrapper = (da.paged_decode_attention_cuda if len(args) == 5
               else da.decode_attention_cuda)
    fn = da.paged_decode_attention if len(args) == 5 else da.decode_attention
    before = wrapper.launches
    if _MLA[case].get("refused"):
        with pytest.raises(ValueError, match="576"):
            fn(*args, **c)
        assert wrapper.launches == before
        return
    out = fn(*args, **c)
    assert wrapper.launches == before + 1
    _close(out, _mla_plain(plain, c), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["dense_same", "dense_two_arrays",
                                  "dense_window_softcap_sinks",
                                  "dense_128_heads", "paged_same_bs64",
                                  "paged_128_heads_bs64",
                                  "paged_two_arrays_bs32",
                                  "paged_window_mid_page",
                                  "dense_tile_edges", "dense_24_heads_s2",
                                  "paged_tile_edges_bs16",
                                  "paged_same_bs8"])
def test_mla_int8_decode_at_576(dtype, case):
    """Kernels 6 and 7's int8 branch at D 576 over the int8 latent (one
    scale a row, shared by k and v): NaN scales on every row no slot
    attends change nothing. A refused case raises and launches nothing."""
    dev = _card()
    args, c, (plain, scales) = _mla_inputs(case, dtype, dev, quant=True)
    paged = len(args) == 5
    wrapper = (da.paged_decode_attention_quant_cuda if paged
               else da.decode_attention_quant_cuda)
    before = wrapper.launches
    fn = da.paged_decode_attention if paged else da.decode_attention
    if _MLA[case].get("refused"):
        with pytest.raises(ValueError, match="576"):
            fn(*args, **c)
        assert wrapper.launches == before
        return
    out = fn(*args, **c)
    assert wrapper.launches == before + 1
    _close(out, _mla_plain(plain, c, scales), dtype)


@pytest.mark.parametrize("case", ["dense_same", "paged_same_bs16",
                                  "paged_same_bs64_int8"])
def test_mla_decode_is_deterministic(case):
    """The wide body's calls and CUDA-graph replays are bitwise equal,
    over the bf16 caches and the int8 pool (`_int8`)."""
    dev = _card()
    quant = case.endswith("_int8")
    args, c, _ = _mla_inputs(case.removesuffix("_int8"), torch.bfloat16,
                             dev, quant=quant)
    fn = da.paged_decode_attention if len(args) == 5 else da.decode_attention

    def call():
        return fn(*args, **c)

    first = call()
    assert torch.equal(first, call())
    assert torch.equal(first, _replayed(call))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["dense_same", "paged_same_bs16",
                                  "dense_same_int8", "paged_same_bs64_int8"])
def test_mla_decode_bodies(dtype, case):
    """A call at 576 launches one kernel: in bf16 the tensor-core body
    (`decode_wide_mma`) over the dense cache and the pool, bf16 and int8,
    never the CUDA-core one; in fp32 the CUDA-core parity body
    (`decode_wide_kernel`)."""
    dev = _card()
    quant = case.endswith("_int8")
    args, c, _ = _mla_inputs(case.removesuffix("_int8"), dtype, dev,
                             quant=quant)
    fn = da.paged_decode_attention if len(args) == 5 else da.decode_attention
    names = _kernel_names(lambda: fn(*args, **c))
    assert len(names) == 1, names
    body = "decode_wide_mma" if dtype == torch.bfloat16 else \
        "decode_wide_kernel"
    assert body in names[0], names
    assert ("signed char" in names[0]) == quant, names


# The expanded prefill: q, k and v (padded) 192 wide, H = Hkv = 16.
_FLASH_192 = {
    "generate_8x512": dict(b=8, s=512),
    "serve_b1_s1024": dict(b=1, s=1024),
    "tail_s333": dict(b=2, s=333),
    "b1_s1": dict(b=1, s=1),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_FLASH_192))
def test_flash_forward_at_192(dtype, case):
    """Kernel 2 at D 192 (one-stage ring in bf16) against its plain
    version; v carries MLA's zero pad past 128, which the output keeps."""
    dev = _card()
    b, s = _FLASH_192[case]["b"], _FLASH_192[case]["s"]
    gen = torch.Generator(device=dev).manual_seed(s + 192)
    q = _randn(gen, (b, s, 16, 192), dtype, dev)
    k = _randn(gen, (b, s, 16, 192), dtype, dev)
    v = torch.nn.functional.pad(_randn(gen, (b, s, 16, 128), dtype, dev),
                                (0, 64))
    before = fa.flash_attention_cuda.launches
    out = fa.flash_attention(q, k, v)
    assert fa.flash_attention_cuda.launches == before + 1
    _close(out, fa.flash_attention_ref(q, k, v), dtype)
    assert not out[..., 128:].any()


# MLA training at 192: packed segments and a ragged S, v (and so dO's
# live lanes) 128 wide padded to 192 as the model pads them; and what
# the bf16 bodies must not assume: v and dO live past 128 ("pad" False),
# GQA, a window with a softcap, S of 1 and one past a 64-row kv tile.
_BWD_192 = {
    "causal_s300": dict(b=2, s=300, bounds=None),
    "segments_s1000": dict(b=1, s=1000, bounds=(0, 50, 130, 131, 600, 1000)),
    "odd_s129": dict(b=1, s=129, bounds=(0, 64, 129)),
    "unpadded_v_s300": dict(b=2, s=300, bounds=None, pad=False),
    "gqa_h8_hkv2": dict(b=2, s=260, bounds=None, hkv=2),
    "window_softcap": dict(b=1, s=500, bounds=None, hkv=4, window=100,
                           softcap=5.0),
    "s1": dict(b=2, s=1, bounds=None),
    "s65": dict(b=1, s=65, bounds=None, hkv=2),
}


def _bwd_192_inputs(case, dtype, dev):
    """q, k, v, dO at 192 (H 8), segments and the options of a case."""
    c = _BWD_192[case]
    b, s, hkv = c["b"], c["s"], c.get("hkv", 8)
    gen = torch.Generator(device=dev).manual_seed(s + 192)
    q = _randn(gen, (b, s, 8, 192), dtype, dev)
    k = _randn(gen, (b, s, hkv, 192), dtype, dev)
    if c.get("pad", True):
        v = torch.nn.functional.pad(_randn(gen, (b, s, hkv, 128), dtype,
                                           dev), (0, 64))
    else:
        v = _randn(gen, (b, s, hkv, 192), dtype, dev)
    do = _randn(gen, (b, s, 8, 192), dtype, dev)
    seg = None
    if c["bounds"] is not None:
        seg = torch.zeros((b, s), dtype=torch.int32, device=dev)
        for i in range(len(c["bounds"]) - 1):
            seg[:, c["bounds"][i]:c["bounds"][i + 1]] = i
    opts = {k_: c[k_] for k_ in ("window", "softcap") if k_ in c}
    return q, k, v, do, seg, opts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(_BWD_192))
def test_flash_192_backward_and_segments(dtype, case):
    """Kernels 2 (with segments), 3 and 4 at D 192 against their plain
    versions, and the autograd Function against autograd through the
    plain attention."""
    dev = _card()
    q, k, v, do, seg, opts = _bwd_192_inputs(case, dtype, dev)
    out, lse = fa.flash_attention_cuda(q, k, v, segments=seg, with_lse=True,
                                       **opts)
    rout, rlse = fa.flash_forward_ref(q, k, v, segments=seg, **opts)
    _close(out, rout, dtype)
    _close(lse, rlse, torch.float32 if dtype == torch.float32 else dtype)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         rout.float()).contiguous()
    before = (fa.flash_bwd_dkdv_cuda.launches, fa.flash_bwd_dq_cuda.launches)
    dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, rlse, delta, segments=seg,
                                    **opts)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, rlse, delta, segments=seg, **opts)
    assert (fa.flash_bwd_dkdv_cuda.launches,
            fa.flash_bwd_dq_cuda.launches) == (before[0] + 1, before[1] + 1)
    rdk, rdv = fa.flash_bwd_dkdv_ref(q, k, v, do, rlse, delta, segments=seg,
                                     **opts)
    rdq = fa.flash_bwd_dq_ref(q, k, v, do, rlse, delta, segments=seg, **opts)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.dtype == dtype
        _scaled_close(got, ref, dtype, name, _zero_scale(ref, rdv))
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ref_ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (fa.flash_bwd_dkdv_cuda.launches, fa.flash_bwd_dq_cuda.launches)
    got = torch.autograd.grad(fa.flash_attention(*ins, segments=seg, **opts),
                              ins, do)
    assert (fa.flash_bwd_dkdv_cuda.launches,
            fa.flash_bwd_dq_cuda.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(
        fa.flash_attention_ref(*ref_ins, segments=seg, **opts), ref_ins, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _scaled_close(g, w, dtype, name, _zero_scale(w, want[2]))


def _zero_scale(ref, dv):
    """At S 1 the softmax has one key, so dq and dk are exactly zero and
    their rounding is measured against the call's dv."""
    return dv.float().abs().max() if not ref.any() else None


def _kernel_names(fn):
    """Names of the kernels one call of fn launched, by torch.profiler.
    The window opens on `torch.cuda._sleep`'s spin kernel, which is left
    out; a trace that holds no kernel at all (the profiler now and then
    loses a window's device activity) is taken again, twice at most."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.self_device_time_total > 0
                 for _ in range(e.count) if "spin_kernel" not in e.key]
        if names:
            return names
    raise AssertionError("the profiler recorded no kernel in three tries")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("segments", [False, True])
def test_flash_192_backward_bodies(dtype, segments):
    """A call of kernel 3 or 4 at 192 launches one kernel: in bf16 the
    wgmma body (`flash_bwd_dkdv_wgmma<192, SEG>`, `flash_bwd_dq_wgmma`),
    never a CUDA-core body; in fp32 the CUDA-core parity body."""
    dev = _card()
    case = "segments_s1000" if segments else "causal_s300"
    q, k, v, do, seg, opts = _bwd_192_inputs(case, dtype, dev)
    rout, rlse = fa.flash_forward_ref(q, k, v, segments=seg, **opts)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         rout.float()).contiguous()
    body = "wgmma" if dtype == torch.bfloat16 else "simt"
    for kernel, call in (
            ("flash_bwd_dkdv", lambda: fa.flash_bwd_dkdv_cuda(
                q, k, v, do, rlse, delta, segments=seg)),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq_cuda(
                q, k, v, do, rlse, delta, segments=seg))):
        names = _kernel_names(call)
        assert len(names) == 1, names
        # Demangled (`..._wgmma<192, false>`) or mangled (`ILi192ELb0E`).
        name = names[0].replace("ILi", "<").replace("ELb", ", ")
        assert f"{kernel}_{body}<192" in name, names
        if body == "wgmma":
            flag = ("true", "1E") if segments else ("false", "0E")
            assert any(f"192, {f}" in name for f in flag), names


@pytest.mark.parametrize("case", ["gqa_h8_hkv2", "segments_s1000",
                                  "window_softcap"])
def test_flash_192_backward_is_deterministic(case):
    """At 192 too every dk/dv and dq tile is written by one block with no
    atomics: two calls give bitwise-equal bf16 results."""
    dev = _card()
    q, k, v, do, seg, opts = _bwd_192_inputs(case, torch.bfloat16, dev)
    _, lse = fa.flash_forward_ref(q, k, v, segments=seg, **opts)
    delta = torch.randn(lse.shape, device=dev)
    runs = []
    for _ in range(2):
        dk, dv = fa.flash_bwd_dkdv_cuda(q, k, v, do, lse, delta,
                                        segments=seg, **opts)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, segments=seg,
                                  **opts)
        runs.append((dq, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------------ training on the card


@pytest.mark.parametrize("kind", ["int8", "int8_bwd"])
def test_int8_training_dots_on_the_card(kind):
    """`torch._int_mm` on the card gives the CPU's int8 dots (the int32
    sums are exact, the quantization the same fp32 arithmetic), forward
    and both backward rules; a product outside the card's int8 matmul
    shapes raises instead of falling back."""
    from shellac_tpu_torch.ops import qtrain

    dev = _card()
    gen = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn((3, 24, 128), generator=gen)
    w = torch.randn((128, 256), generator=gen) * 0.1
    g = torch.randn((3, 24, 256), generator=gen)
    res = {}
    for where in ("cpu", dev):
        xi = x.to(where).requires_grad_()
        wi = w.to(where).requires_grad_()
        out = qtrain.quant_dot(xi, wi, kind)
        res[str(where)] = (out,) + torch.autograd.grad(out, (xi, wi),
                                                       g.to(where))
    for a, b in zip(res["cpu"], res[str(dev)]):
        torch.testing.assert_close(b.cpu(), a,
                                   atol=1e-5 * a.abs().max().item(), rtol=0)
    small = torch.randn((1, 8, 128), device=dev)
    with pytest.raises(ValueError, match="int8"):
        qtrain.quant_dot(small, w.to(dev), kind)


def test_device_prefetch_stages_batches_in_order():
    """Batches reach the card through pinned buffers in order, a batch of
    another shape through pageable memory, the last one intact."""
    import numpy as np

    from shellac_tpu_torch.training.data import device_prefetch

    dev = _card()
    rng = np.random.default_rng(0)
    batches = [{"inputs": rng.integers(0, 99, size=(2, 8)).astype(np.int32),
                "targets": rng.integers(0, 99, size=(2, 8))}
               for _ in range(6)]
    batches[3] = {k: v[:1] for k, v in batches[3].items()}
    got = list(device_prefetch(iter(batches), device=dev, depth=2))
    assert len(got) == len(batches)
    for a, b in zip(got, batches):
        for k in b:
            assert a[k].is_cuda
            np.testing.assert_array_equal(a[k].cpu().numpy(), b[k])


def test_mla_training_at_192_through_the_kernels():
    """Two fp32 train steps of an MLA model at DeepSeek's head widths
    (qk 128 + 64 = 192, v 128) through kernels 2-4 on the card, and the
    same steps on the CPU's plain versions: losses and gradient norms
    within 1e-4."""
    from shellac_tpu_torch.config import MLAConfig, TrainConfig
    from shellac_tpu_torch.models import transformer as tt
    from shellac_tpu_torch.models.registry import get_model_config
    from shellac_tpu_torch.training import (
        make_train_step,
        train_state_from_params,
    )
    from shellac_tpu_torch.training.train_state import map_tree

    dev = _card()
    cfg = get_model_config("tiny-mla").replace(
        dtype="float32", d_model=128, n_heads=2, remat=True,
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=None,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    params = tt.init_params(cfg, seed=3, device="cpu", master=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 97),
                         generator=torch.Generator().manual_seed(1))
    seg = torch.zeros((2, 96), dtype=torch.int32)
    seg[:, 40:] = 1
    runs = {}
    for where in ("cpu", dev):
        state = train_state_from_params(
            tcfg, map_tree(lambda t: t.clone().to(where), params), cfg)
        step = make_train_step(cfg, tcfg, device=where)
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
                 "segment_ids": seg}
        before = fa.flash_bwd_dq_cuda.launches
        out = []
        for _ in range(2):
            state, m = step(state, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        runs[str(where)] = out
        if where == dev:
            assert fa.flash_bwd_dq_cuda.launches - before == 2 * cfg.n_layers
    for a, b in zip(runs["cpu"], runs[str(dev)]):
        assert abs(a[0] - b[0]) <= 1e-4 * abs(a[0])
        assert abs(a[1] - b[1]) <= 1e-4 * abs(a[1])
