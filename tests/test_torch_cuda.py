"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Every test here needs a CUDA card and skips without one.  The file
imports no JAX, so it also runs on a GPU host that has none (there,
without the JAX-importing conftest):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: f32 1e-5 relative to the output's scale (full fp32 on both
sides, other summation orders); bf16 and f16 1e-2 for the matmul (one
rounding of the output, 2^-8 for bf16, finer for f16) and 2e-2 absolute
for attention (p and dS are rounded to the input type before their
products on both sides, outputs are O(1)).  The weight gradient is f32
from the same inputs on both sides: 1e-4 relative in every dtype (bf16
and f16 products are exact in f32 on the tensor cores too).
im2col is a copy: exact.  col2im sums the same f32 values in the same
order as its plain version: exact in f32, within one rounding of the
output (the dtype's eps relative to the largest output) in bf16 and f16.
The conv path against its plain path: the matmul's tolerances.  The
unsplit xprop kernel runs f32 on the CUDA cores (csrc/bsmm_fprop.cu) and
bf16/f16 on the tensor cores (csrc/bsmm_xprop_mma.cu), each in a fixed
order: two runs agree bit for bit.  The fine and window kernels sum each
output in the LUT's order with bsmm_fprop.cu's fmaf chain: equal to the
unsplit kernel bit for bit in f32; in bf16 and f16 they run on the tensor
cores (csrc/bsmm_fine_mma.cu, csrc/bsmm_window_mma.cu), each in its own
fixed order, and are held against the plain version within the matmul's
tolerances, two runs bit for bit.
The merge adds the same f32 tiles in the same order as its plain
version: exact.  The fused split (bsmm_split, bf16/f16) computes the
partial kernel's accumulators and adds them in the merge's order: equal
to bsmm_merge over bsmm_partials bit for bit.  The attention forward
runs f32 on the CUDA cores (csrc/bst_attn_fwd.cu) and bf16/f16 on the
tensor cores (csrc/bst_attn_fwd_mma.cu), each in a fixed order: two
runs, and the two launch orders of the query rows, agree bit for bit.
The LM's CUDA graphs replay the launches of the eager step they captured,
in the same order on the same buffers: a replayed decode token or train
step equals the eager one bit for bit.
"""
import contextlib
import copy
import ctypes

import numpy as np
import pytest
import torch

import blocksparse_tpu_torch as bt
from blocksparse_tpu_torch import (AdamOptimizer, BlocksparseConv,
                                   BlocksparseMatMul, BlocksparseTransformer,
                                   LSTMConfig, SparseLSTM,
                                   SparseTransformerLM, TransformerConfig,
                                   generate_cached, generate_cached_scan,
                                   lstm_params_from_jax, params_from_jax,
                                   random_jax_conv_filter, random_jax_lstm_params,
                                   random_jax_params)
from blocksparse_tpu_torch.kernels import bsmm as bsmm_kernels
from blocksparse_tpu_torch.kernels import bst_attn, bst_trio
from blocksparse_tpu_torch.kernels import im2col as im2col_kernels
from blocksparse_tpu_torch.models import sparse_transformer as lm
from blocksparse_tpu_torch.models.sparse_transformer import (
    causal_subblock_mask, fixed_layout)

F32_TOL = 1e-5
BSMM_BF16_TOL = 1e-2
ATTN_BF16_TOL = 2e-2
# the attention's dq beside its max limit: ||got - ref|| / ||ref|| (a
# typical |dq| is far below max|dq|, so the max limit alone would pass a
# dropped entry)
ATTN_NORM_TOL = 1e-2
UPDAT_TOL = 1e-4
HALF = (torch.bfloat16, torch.float16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    return torch.device("cuda")


def random_layout(CB, KB, density, seed):
    rng = np.random.RandomState(seed)
    layout = (rng.rand(CB, KB) < density).astype(np.int32)
    layout[np.arange(CB), np.arange(CB) % KB] = 1
    layout[np.arange(KB) % CB, np.arange(KB)] = 1
    return layout


def _xprop_layout(bsize, seed):
    """A square layout whose output column 0, in fprop and in bprop, holds
    3·KC/b + 1 entries (KC = max(b, 64) contraction rows a stage of
    bsmm_xprop_mma.cu's ring: more than three stages, and an odd count, so
    b8's last entry pair is padded), with output column 2 and input
    block-row 2 empty."""
    n = 3 * max(bsize, 64) // bsize + 2
    layout = random_layout(n, n, 0.5, seed=seed)
    layout[:, 0] = 1
    layout[0, :] = 1
    layout[:, 2] = 0
    layout[2, :] = 0
    return layout


def _check_xprop_kernel(device, bsize, dtype, d, route):
    """fprop (d "f") or bprop ("b") of the unsplit kernel (route "unsplit",
    mode="grouped") or its partial tiles (route "partials", merged by
    merge_plain) against the plain version at N 1, 5, 300 and TM + 1: one
    launch a call on the direction's counter, two runs equal bit for bit,
    the empty column (and the partials' sentinel tile) exactly zero."""
    layout = _xprop_layout(bsize, seed=bsize + (d == "b"))
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                           mode="grouped")
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                              impl="xla")
    lut = op._lut(device)
    counter = bsmm_kernels.bsmm_bprop if d == "b" else bsmm_kernels.bsmm_fprop
    split = op._plan_tensors(device, "split", d, 8)
    n_tiles = split["tile_ptr"].numel() - 1
    g = torch.Generator(device=device).manual_seed(bsize)
    w = torch.randn(op.w_shape, device=device, generator=g).to(dtype)
    width = op.C if d == "f" else op.K
    for N in (1, 5, 300, bsmm_kernels.XPROP_TM[bsize] + 1):
        x = torch.randn((N, width), device=device, generator=g).to(dtype)

        def run():
            if route == "unsplit":
                return op._xprop(x, w, d)
            return bsmm_kernels.bsmm_partials(
                x, w, split["tile_ptr"], lut[f"{d}_ent_in"], lut[f"{d}_ent_w"],
                bsize, n_tiles, d == "b", plan=op._xlaunch(device, d, N, 8))
        before = counter.launches
        y, again = run(), run()
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        assert torch.equal(y, again)
        if route == "partials":
            assert y.dtype == torch.float32 and (y[:, -bsize:] == 0).all()
            y = bsmm_kernels.merge_plain(y, split["merge_idx"].long(), bsize,
                                         dtype)
        assert y.dtype == dtype and y.shape == (N, width)
        ref = plain._xprop(x, w, d).float()
        torch.testing.assert_close(
            y.float(), ref, rtol=0,
            atol=_tol(dtype, BSMM_BF16_TOL, ref.abs().max().item()))
        assert (y[:, 2 * bsize:3 * bsize] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["unsplit", "partials"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_bsmm_kernel_matches_plain(cuda, bsize, dtype, route):
    _check_xprop_kernel(cuda, bsize, dtype, "f", route)


@pytest.mark.cuda
def test_xprop_kernel_by_dtype(cuda, monkeypatch):
    """f32 launches bsmm_fprop.cu's kernel, bf16 and f16 bsmm_xprop_mma.cu's
    (fprop, bprop and partials alike); the latter refuses f32 itself, and an
    x that starts off a 16-byte boundary gives the same result."""
    from blocksparse_tpu_torch.kernels import _build
    layout = random_layout(4, 4, 0.5, seed=3)
    op = BlocksparseMatMul(layout, block_size=16, feature_axis=1,
                           mode="grouped")
    lut = op._lut(cuda)
    split = op._plan_tensors(cuda, "split", "f", 2)
    used = []
    build_fn = _build.function

    def spy(name, fn_name, argtypes):
        used.append((name, fn_name))
        return build_fn(name, fn_name, argtypes)
    monkeypatch.setattr(_build, "function", spy)
    g = torch.Generator(device=cuda).manual_seed(3)
    for dtype in (torch.float32, *HALF):
        x = torch.randn((40, op.C), device=cuda, generator=g).to(dtype)
        w = torch.randn(op.w_shape, device=cuda, generator=g).to(dtype)
        used.clear()
        y = op._xprop(x, w, "f")
        op._xprop(torch.randn((40, op.K), device=cuda, generator=g).to(dtype),
                  w, "b")
        bsmm_kernels.bsmm_partials(x, w, split["tile_ptr"], lut["f_ent_in"],
                                   lut["f_ent_w"], 16,
                                   split["tile_ptr"].numel() - 1,
                                   plan=op._xlaunch(cuda, "f", 40, 2))
        lib, fn = ("bsmm_fprop", "bsmm_xprop_nc") if dtype == torch.float32 \
            else ("bsmm_xprop_mma", "bsmm_xprop_mma_nc")
        assert used == [(lib, fn), (lib, fn), (lib, fn + "_partials")]
        off = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:]
        off = off.view_as(x).copy_(x)
        assert off.data_ptr() % 16 and torch.equal(op._xprop(off, w, "f"), y)
    refused = build_fn("bsmm_xprop_mma", "bsmm_xprop_mma_nc",
                       bsmm_kernels._XPROP_ARGS)(
        0, 16, 0, x.data_ptr(), w.data_ptr(), lut["f_row_ptr"].data_ptr(),
        lut["f_ent_in"].data_ptr(), lut["f_ent_w"].data_ptr(), y.data_ptr(),
        40, op.C, op.K, bsmm_kernels._stream(x))
    assert refused == 1                      # cudaErrorInvalidValue


@pytest.mark.cuda
def test_bsmm_kernel_feature_axis_0(cuda):
    layout = random_layout(4, 6, 0.5, seed=1)
    port = BlocksparseMatMul(layout, block_size=32, feature_axis=0)
    plain = BlocksparseMatMul(layout, block_size=32, feature_axis=0,
                              impl="xla")
    x = torch.randn(port.i_shape(70), device=cuda)
    w = torch.randn(port.w_shape, device=cuda)
    torch.testing.assert_close(port(x, w), plain(x, w), rtol=0,
                               atol=F32_TOL * 64)


@pytest.mark.cuda
def test_bsmm_kernel_rejects_cpu_and_mixed_dtypes(cuda):
    """The kernel wrappers refuse mixed dtypes, f64 and a CPU tensor; the
    op multiplies mixed operands in their promoted dtype (the JAX product
    of a bf16 and an f32 operand, ROADMAP F6), rounded to x's dtype."""
    layout = random_layout(2, 2, 1.0, seed=0)
    port = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    x = torch.randn((4, port.C), device=cuda)
    w16 = torch.randn(port.w_shape, device=cuda).bfloat16()
    lut = port._lut(cuda)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_fprop(x, w16, lut["f_row_ptr"], lut["f_ent_in"],
                                lut["f_ent_w"], 16, port.KB,
                                plan=port._xlaunch(cuda, "f", 4))
    y = port(x, w16)
    assert y.dtype == torch.float32 and torch.equal(y, port(x, w16.float()))
    with pytest.raises(TypeError):
        port(x.double(), torch.randn(port.w_shape, device=cuda).double())
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(x.cpu(), torch.ones(port.w_shape), None,
                                None, None, 16, 2)


def _fixed_case(device, dtype, batch=2, ctx=256, bs=64, heads=2, hs=64,
                local=2):
    layout = fixed_layout(ctx // bs, local_blocks=local)
    port = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=causal_subblock_mask)
    g = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((batch, ctx, 3 * heads * hs), device=device,
                      generator=g).to(dtype)
    return port, qkv.split(heads * hs, dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("bs,hs,blocks,local", [
    (16, 16, 16, 2), (32, 128, 8, 2), (64, 64, 4, 2), (64, 32, 4, 2),
    (64, 64, 32, 8)])     # the last: the LM's layout, 1-14 entries a row
def test_attention_kernel_matches_plain(cuda, bs, hs, blocks, local, dtype):
    port, (q, k, v) = _fixed_case(cuda, dtype, ctx=blocks * bs, bs=bs, hs=hs,
                                  local=local)
    before = bst_attn.attention_fwd.launches
    y = port.attention(q, k, v, scale=1.0 / np.sqrt(hs))   # strided q/k/v
    torch.cuda.synchronize()
    assert bst_attn.attention_fwd.launches == before + 1
    ref = _plain_twin(port).attention(q, k, v, scale=1.0 / np.sqrt(hs))
    tol = F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=tol)


def _f1_mask(blk_shape, head, qry, key, blk):
    """Causal diagonal, except that query row 3 of block-row 1 sees no
    key at all."""
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def _fwd_tol(dtype, ref):
    """F32_TOL absolute in f32; in bf16/f16 ATTN_BF16_TOL of
    max(1, max|ref|)."""
    if dtype == torch.float32:
        return F32_TOL
    return ATTN_BF16_TOL * max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_attention_kernel_fully_masked_row_is_zero(cuda, dtype):
    heads = 2
    layout = np.tril(np.ones((4, 4), np.int32))
    port = BlocksparseTransformer(layout, block_size=16, heads=heads,
                                  mask_callback=_f1_mask)
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 64, heads * 16), device=cuda,
                           generator=g).to(dtype) for _ in range(3))
    y = port.attention(q, k, v, scale=0.25)
    ref = _plain_twin(port).attention(q, k, v, scale=0.25)
    dead = 16 + 3
    assert (y[:, dead] == 0).all() and (ref[:, dead] == 0).all()
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float(), ref.float(), rtol=0,
                               atol=_fwd_tol(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_attention_kernel_per_head_layouts(cuda, dtype):
    lay = fixed_layout(4, local_blocks=2)
    layout = np.stack([lay, lay[:, ::-1], lay, np.flipud(lay)])
    port = BlocksparseTransformer(layout, block_size=16, heads=4,
                                  mask_callback=causal_subblock_mask)
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((3, 64, 4 * 32), device=cuda,
                           generator=g).to(dtype) for _ in range(3))
    ref = _plain_twin(port).attention(q, k, v, scale=0.3)
    torch.testing.assert_close(port.attention(q, k, v, scale=0.3).float(),
                               ref.float(), rtol=0, atol=_fwd_tol(dtype, ref))


def _csr_order(tab):
    """The tables with both launch orders replaced by CSR order."""
    out = dict(tab)
    for name in ("order", "order_t"):
        lh, rows = tab[name].shape
        out[name] = torch.arange(rows, dtype=torch.int32,
                                 device=tab[name].device).repeat(lh, 1)
    return out


def _kernel_fwd(port, q, k, v, scale, ordered=True):
    """(out of attention_fwd, (out, lse) of attention_fwd_lse), the query
    rows launched in the tables' order or in CSR order (``ordered=False``;
    the wgmma forward reads the pair plan, which no order changes)."""
    tab = port._tables(q.device)
    if not ordered:
        tab = _csr_order(tab)
    return (bst_attn.attention_fwd(q, k, v, tab, port.heads, scale),
            *bst_attn.attention_fwd_lse(q, k, v, tab, port.heads, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_attention_fwd_kernels_bit_equal(cuda, dtype):
    """Two runs of attention_fwd and of attention_fwd_lse give the same
    bits (every sum in the CSR order, no atomics), the two entry points
    the same out, and the launch order of the query rows changes none of
    them; at the LM's bs 64 / hs 64 on a 16-block-row fixed layout."""
    port, (q, k, v) = _fixed_case(cuda, dtype, ctx=1024, local=4)
    first = _kernel_fwd(port, q, k, v, 0.125)
    again = _kernel_fwd(port, q, k, v, 0.125)
    csr = _kernel_fwd(port, q, k, v, 0.125, ordered=False)
    torch.cuda.synchronize()
    assert torch.equal(first[0], first[1])
    for a, b, c in zip(first, again, csr):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_attention_fwd_negative_and_zero_scale(cuda, scale, dtype):
    """A negative scale (the tensor-core kernel flips q's sign, so its
    running max stays a max) and a zero scale (every visible key weighs
    the same; masked keys stay out) match the plain version, out and
    lse."""
    port, (q, k, v) = _fixed_case(cuda, dtype, bs=32, hs=32)
    tab = port._tables(cuda)
    out, lse = _kernel_fwd(port, q, k, v, scale)[1:]
    ref, lse_ref = bst_attn.attention_fwd_lse_plain(
        q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], port.heads, 32,
        scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=_fwd_tol(dtype, ref))
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_attention_fwd_source_by_dtype(cuda, monkeypatch):
    """f32 launches bst_attn_fwd.cu, bf16 and f16 bst_attn_fwd_mma.cu; each
    source refuses the other's dtypes (cudaErrorInvalidValue)."""
    from blocksparse_tpu_torch.kernels import _build
    used = []
    build_fn = _build.function

    def spy(name, fn_name, argtypes):
        used.append((name, fn_name))
        return build_fn(name, fn_name, argtypes)
    monkeypatch.setattr(_build, "function", spy)
    for dtype in (torch.float32, *HALF):
        port, (q, k, v) = _fixed_case(cuda, dtype, bs=16, hs=32)
        used.clear()
        _kernel_fwd(port, q, k, v, 0.3)
        lib = "bst_attn_fwd" if dtype == torch.float32 else "bst_attn_fwd_mma"
        assert used == [(lib, lib)] * 2
    tab = port._tables(cuda)
    out = torch.empty(q.shape, dtype=torch.float32, device=cuda)
    lse = torch.empty((2, port.heads, q.shape[1]), device=cuda)
    strides = (ctypes.c_longlong * 6)(*(
        s for t in (q, k, v) for s in t.stride()[:2]))
    for lib, codes in (("bst_attn_fwd", (1, 2)), ("bst_attn_fwd_mma", (0,))):
        fn = build_fn(lib, lib, bst_attn._FWD_ARGS)
        for code in codes:
            for lse_ptr in (None, lse.data_ptr()):
                assert fn(code, 16, 32, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), out.data_ptr(), lse_ptr,
                          ctypes.addressof(strides),
                          tab["row_ptr"].data_ptr(), tab["ent_k"].data_ptr(),
                          tab["ent_code"].data_ptr(), tab["uniq"].data_ptr(),
                          None, 2, port.heads, 1, q.shape[1] // 16, 0.3,
                          torch.cuda.current_stream().cuda_stream) == 1, \
                    (lib, code)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_attention_fwd_unaligned_views(cuda, dtype):
    """q, k and v that start off a 16-byte boundary, or whose row stride is
    off 16 bytes, give the same out and lse as their contiguous copies (the
    wrapper hands the tensor-core kernel an aligned copy)."""
    port, (q, k, v) = _fixed_case(cuda, dtype, bs=32, hs=16)
    want = _kernel_fwd(port, *(t.contiguous() for t in (q, k, v)), 0.25)

    def shifted(t):      # starts 2 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
        return buf.view_as(t).copy_(t)

    def padded(t):       # rows 2 elements wider than the data: 4 bytes off
        buf = torch.zeros(t.shape[:-1] + (t.shape[-1] + 2,), dtype=dtype,
                          device=cuda)
        return buf[..., :t.shape[-1]].copy_(t)
    for move in (shifted, padded):
        views = [move(t) for t in (q, k, v)]
        assert all(t.data_ptr() % 16 or t.stride(1) * t.element_size() % 16
                   for t in views)
        got = _kernel_fwd(port, *views, 0.25)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), move.__name__


@pytest.mark.cuda
def test_model_kernels_match_plain_model(cuda):
    cfg = dict(n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=64,
               blk_size=16, attn_layout="fixed", local_blocks=2,
               mlp_ratio=4, mlp_block_size=16, mlp_density=0.5,
               dtype="float32")
    port = SparseTransformerLM(TransformerConfig(**cfg), device=cuda)
    plain = SparseTransformerLM(TransformerConfig(**cfg), device=cuda,
                                impl="xla")
    sd = params_from_jax(random_jax_params(port, seed=4), port)
    port.load_state_dict(sd)
    plain.load_state_dict(sd)
    tokens = torch.randint(0, 64, (2, 64), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(3))
    before = (bsmm_kernels.bsmm_fprop.launches,
              bst_attn.attention_fwd.launches)
    got = port(tokens)
    assert bsmm_kernels.bsmm_fprop.launches - before[0] == 2 * 2
    assert bst_attn.attention_fwd.launches - before[1] == 2
    torch.testing.assert_close(got, plain(tokens), rtol=1e-4, atol=1e-4)


def _tol(dtype, half_tol, scale):
    return (F32_TOL if dtype == torch.float32 else half_tol) * max(1.0, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["unsplit", "partials"])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_bsmm_bprop_kernel_matches_plain(cuda, bsize, dtype, route):
    _check_xprop_kernel(cuda, bsize, dtype, "b", route)


@pytest.mark.cuda
@pytest.mark.parametrize("by_c", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_bsmm_updat_kernel_matches_plain(cuda, bsize, dtype, by_c):
    """At N 1, 77, 1500 and 4096.  f32 runs bsmm_updat.cu (CUDA cores,
    unsplit).  bf16/f16 run the kernel updat_kernel picks
    (bsmm_updat_sparse.cu at b32 and b64, whose plan reads at most
    UPDAT_SP_MAX_TILES of the tiles here; bsmm_updat_wgmma.cu at b128,
    bsmm_updat_mma.cu at b8 and b16) over its plan's groups: a
    4-row layout whose row 0 holds more than one group's G = 256 / b
    blocks, grouped by x block-row, or its transpose, grouped by dy
    block-column; N split where the rule says (1500 and 4096 here: N //
    512 runs bind before the SM count), the runs' partials summed by
    bsmm_updat_reduce.  Two runs equal bit for bit."""
    G = bsmm_kernels.UPDAT_ROWS // bsize
    layout = random_layout(4, G + 3, 0.3, seed=bsize)
    layout[0, :] = 1
    if not by_c:
        layout = layout.T.copy()
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                              impl="xla")
    assert port._plan("updat", "u")["by_c"] == by_c
    g = torch.Generator(device=cuda).manual_seed(2)
    counters = (bsmm_kernels.bsmm_updat, bsmm_kernels.bsmm_updat_reduce)
    for N in (1, 77, 1500, 4096):
        splits = port.updat_splits(N, dtype)
        half = dtype != torch.float32
        assert splits == ({1500: 2, 4096: 8}.get(N, 1) if half else 1)
        x = torch.randn((N, port.C), device=cuda, generator=g).to(dtype)
        dy = torch.randn((N, port.K), device=cuda, generator=g).to(dtype)
        before = [c.launches for c in counters]
        dw, again = port._updat(x, dy), port._updat(x, dy)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == \
            [2, 2 if splits > 1 else 0]
        assert torch.equal(dw, again)
        ref = plain._updat(x, dy)
        assert dw.dtype == torch.float32 and dw.shape == port.w_shape
        torch.testing.assert_close(
            dw, ref, rtol=0, atol=UPDAT_TOL * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
def test_updat_reduce_kernel_equals_plain_and_raises(cuda):
    """The split's second pass adds the partials in run order: equal to
    updat_reduce_plain bit for bit; a CPU tensor, another dtype or a
    partial size not a multiple of 4 raises."""
    g = torch.Generator(device=cuda).manual_seed(4)
    parts = torch.randn((7, 5, 32, 32), device=cuda, generator=g) * 1e3
    before = bsmm_kernels.bsmm_updat_reduce.launches
    dw = bsmm_kernels.bsmm_updat_reduce(parts)
    torch.cuda.synchronize()
    assert bsmm_kernels.bsmm_updat_reduce.launches == before + 1
    assert torch.equal(dw, bsmm_kernels.updat_reduce_plain(parts))
    for bad in (parts.cpu(), parts.double(), parts[:, :, :1, :3].contiguous()):
        with pytest.raises(ValueError):
            bsmm_kernels.bsmm_updat_reduce(bad)
    layout = random_layout(2, 2, 1.0, seed=0)
    op = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    lut = op._lut(cuda)
    x = torch.randn((8, op.C), device=cuda).bfloat16()
    with pytest.raises(ValueError):          # bf16 needs the plan
        bsmm_kernels.bsmm_updat(x, x, lut["u_c32"], lut["u_k32"], 16)


@pytest.mark.cuda
def test_embedding_backward_is_bit_equal_on_the_card(cuda):
    """The LM's shape: 8 x 2048 ids into a 256 x 512 bf16 table.  Two
    backward runs give the same bits (the sorted segment sum, no
    atomics), in bf16, within one bf16 rounding of an f32 sum."""
    from blocksparse_tpu_torch import embedding_lookup
    g = torch.Generator(device=cuda).manual_seed(9)
    ids = torch.randint(0, 256, (8, 2048), device=cuda, generator=g)
    dy = torch.randn((8, 2048, 512), device=cuda, generator=g).bfloat16()
    emb = torch.randn((256, 512), device=cuda, generator=g).bfloat16()
    grads = []
    for _ in range(2):
        e = emb.clone().requires_grad_()
        embedding_lookup(e, ids).backward(dy)
        grads.append(e.grad)
    assert grads[0].dtype == torch.bfloat16
    assert torch.equal(grads[0], grads[1])
    ref = torch.zeros((256, 512), device=cuda).index_add_(
        0, ids.reshape(-1), dy.reshape(-1, 512).float())
    torch.testing.assert_close(grads[0].float(), ref, rtol=2.0 ** -8,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 0])
def test_bsmm_autograd_runs_the_three_kernels(cuda, axis):
    layout = random_layout(4, 6, 0.5, seed=5)
    port = BlocksparseMatMul(layout, block_size=32, feature_axis=axis)
    plain = BlocksparseMatMul(layout, block_size=32, feature_axis=axis,
                              impl="xla")
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn(port.i_shape(200), device=cuda, generator=g)
    w0 = torch.randn(port.w_shape, device=cuda, generator=g)
    dy = torch.randn(port.o_shape(200), device=cuda, generator=g)
    grads = []
    for op in (port, plain):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        counts = [k.launches for k in (bsmm_kernels.bsmm_fprop,
                                       bsmm_kernels.bsmm_bprop,
                                       bsmm_kernels.bsmm_updat)]
        op(x, w).backward(dy)
        torch.cuda.synchronize()
        moved = [k.launches - c for k, c in zip(
            (bsmm_kernels.bsmm_fprop, bsmm_kernels.bsmm_bprop,
             bsmm_kernels.bsmm_updat), counts)]
        assert moved == ([1, 1, 1] if op is port else [0, 0, 0])
        grads.append((x.grad, w.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-4 * ref.abs().max().item())
    # bf16 on a dense layout (every staged x tile serving all its
    # group's columns) at an N whose tiles fill the card: the three
    # products on the wgmma kernels, at b32 bsmm_xprop_sparse.cu twice
    # (counted in launches_sparse, each with its weights' packing) and
    # bsmm_updat_sparse.cu (the dense layout's identical x block-rows
    # bundled: its plan reads half the tiles), and at b64
    # bsmm_xprop_wgmma.cu twice and bsmm_updat_wgmma.cu (7 tiles of 8)
    N = 128 * bsmm_kernels.device_sm_count(cuda) + 40
    kernels = (bsmm_kernels.bsmm_fprop, bsmm_kernels.bsmm_bprop,
               bsmm_kernels.bsmm_updat)
    for bsize, xk in ((32, "sparse"), (64, "wgmma")):
        lay = np.ones((128 // bsize, 192 // bsize), np.int32)
        port = BlocksparseMatMul(lay, block_size=bsize, feature_axis=axis)
        plain = BlocksparseMatMul(lay, block_size=bsize, feature_axis=axis,
                                  impl="xla")
        assert [port.kernel_of(N, d) for d in "fbu"] == [
            f"bsmm_xprop_{xk}", f"bsmm_xprop_{xk}", f"bsmm_updat_{xk}"]
        x0 = torch.randn(port.i_shape(N), device=cuda, generator=g).bfloat16()
        w0 = (torch.randn(port.w_shape, device=cuda, generator=g)
              * 0.1).bfloat16()
        dy = torch.randn(port.o_shape(N), device=cuda, generator=g).bfloat16()
        grads = []
        for op in (port, plain):
            x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            counts = [(k.launches, getattr(k, f"launches_{xk}", 0),
                       k.launches_wgmma) for k in kernels]
            packs = bsmm_kernels.xprop_sparse_pack.launches
            y = op(x, w)
            y.backward(dy)
            torch.cuda.synchronize()
            moved = [(k.launches - c, getattr(k, f"launches_{xk}", 0) - cx,
                      k.launches_wgmma - cw)
                     for k, (c, cx, cw) in zip(kernels, counts)]
            if op is port:
                assert moved == [(1, 1, xk == "wgmma")] * 3
                assert bsmm_kernels.xprop_sparse_pack.launches - packs == \
                    2 * (xk == "sparse")
            else:
                assert moved == [(0, 0, 0)] * 3
            grads.append((y.detach(), x.grad, w.grad))
        for got, ref in zip(*grads):
            torch.testing.assert_close(
                got.float(), ref.float(), rtol=0,
                atol=BSMM_BF16_TOL * max(1.0, ref.float().abs().max().item()))


WGMMA_SIZES = (32, 64, 128)


def _wgmma_layout(bsize, seed):
    """2G + 3 output block-columns (three groups of G = 256 / b, the last
    short) over as many input blocks, random at 0.5, output column 2 and
    input block-row 2 empty: every group's items, masks with gaps, an
    empty column and an empty bprop column."""
    n = 2 * (256 // bsize) + 3
    layout = random_layout(n, n, 0.5, seed=seed)
    layout[:, 2] = 0
    layout[2, :] = 0
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("bsize", WGMMA_SIZES)
def test_wgmma_xprop_matches_plain(cuda, bsize, dtype, d):
    """bsmm_xprop_wgmma.cu over xprop_wgmma_plan's groups at N 1, 5, 300
    and a tile plus one (129): against the plain version at the matmul's
    bf16 tolerance, the empty column exactly zero, two runs equal bit for
    bit, one launch a call counted on the direction's wgmma counter."""
    layout = _wgmma_layout(bsize, seed=bsize)
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                              impl="xla")
    lut = op._lut(cuda)
    plan = op._plan_tensors(cuda, "wgmma", d)
    kern = bsmm_kernels.bsmm_bprop if d == "b" else bsmm_kernels.bsmm_fprop
    n_out = op.KB if d == "f" else op.CB
    g = torch.Generator(device=cuda).manual_seed(bsize)
    w = (torch.randn(op.w_shape, device=cuda, generator=g) * 0.2).to(dtype)
    for N in (1, 5, 300, bsmm_kernels.XPROP_WG_TM + 1):
        x = torch.randn((N, op.C if d == "f" else op.K), device=cuda,
                        generator=g).to(dtype)
        before = (kern.launches, kern.launches_wgmma)
        y, again = (kern(x, w, lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"],
                         lut[f"{d}_ent_w"], bsize, n_out, plan=plan)
                    for _ in range(2))
        torch.cuda.synchronize()
        assert (kern.launches, kern.launches_wgmma) == \
            (before[0] + 2, before[1] + 2)
        assert torch.equal(y, again)
        assert y.dtype == dtype and y.shape == (N, n_out * bsize)
        ref = plain._xprop(x, w, d).float()
        torch.testing.assert_close(
            y.float(), ref, rtol=0,
            atol=_tol(dtype, BSMM_BF16_TOL, ref.abs().max().item()))
        assert (y[:, 2 * bsize:3 * bsize] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("by_c", [True, False])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("bsize", WGMMA_SIZES)
def test_wgmma_updat_matches_plain(cuda, bsize, dtype, by_c):
    """bsmm_updat_wgmma.cu over updat_plan's groups (by x block-row, or
    by dy block-column on the transpose) at N 1, 5, 129, 300 unsplit and
    1500 and 4096 split in runs of 64-row stages (the reduce summing the
    runs): against the plain version at UPDAT_TOL, two runs equal bit for
    bit, counted."""
    G = bsmm_kernels.UPDAT_ROWS // bsize
    layout = random_layout(4, G + 3, 0.3, seed=bsize)
    layout[0, :] = 1
    if not by_c:
        layout = layout.T.copy()
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                              impl="xla")
    plan = op._plan_tensors(cuda, "updat", "u")
    assert plan["by_c"] == by_c
    lut = op._lut(cuda)
    sms = bsmm_kernels.device_sm_count(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    for N in (1, 5, 129, 300, 1500, 4096):
        splits = bsmm_kernels.updat_splits(N, plan["grp_q"].numel(), bsize,
                                           sms, "wgmma")
        assert (splits > 1) == (N >= 1024)
        x = torch.randn((N, op.C), device=cuda, generator=g).to(dtype)
        dy = torch.randn((N, op.K), device=cuda, generator=g).to(dtype)
        before = (bsmm_kernels.bsmm_updat.launches_wgmma,
                  bsmm_kernels.bsmm_updat_reduce.launches)
        dw, again = (bsmm_kernels.bsmm_updat(x, dy, lut["u_c32"], lut["u_k32"],
                                             bsize, plan, splits, "wgmma")
                     for _ in range(2))
        torch.cuda.synchronize()
        assert (bsmm_kernels.bsmm_updat.launches_wgmma,
                bsmm_kernels.bsmm_updat_reduce.launches) == \
            (before[0] + 2, before[1] + (2 if splits > 1 else 0))
        assert torch.equal(dw, again)
        ref = plain._updat(x, dy)
        assert dw.dtype == torch.float32 and dw.shape == op.w_shape
        torch.testing.assert_close(
            dw, ref, rtol=0, atol=UPDAT_TOL * max(1.0, ref.abs().max().item()))


def _tap_layout(CB, KB, density, seed, taps=9):
    """A conv-like layout (``BlocksparseConv``'s tap-tiled one): a random
    (CB, KB) channel connectivity, each block's row repeated for the
    taps, so x (CB·taps·b wide) is 9x dy's width when CB == KB."""
    rng = np.random.RandomState(seed)
    lay = np.zeros((CB * taps, KB), np.int32)
    for kb in range(KB):
        for cb in range(CB):
            if cb == kb % CB or rng.rand() < density:
                lay[cb * taps:(cb + 1) * taps, kb] = 1
    return lay


def _sparse_updat(op, x, dy, dev, kernel="sparse"):
    """bsmm_updat on ``kernel`` over its plan, at its own split."""
    kind = "updat_sparse" if kernel == "sparse" else "updat"
    plan = op._plan_tensors(dev, kind, "u")
    lut = op._lut(dev)
    splits = bsmm_kernels.updat_splits(
        x.shape[0], plan["grp_q"].shape[0], op.bsize,
        bsmm_kernels.device_sm_count(dev), kernel)
    return bsmm_kernels.bsmm_updat(x, dy, lut["u_c32"], lut["u_k32"],
                                   op.bsize, plan, splits, kernel), splits


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["taps", "empty_row", "full_row"])
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("bsize", [32, 64])
def test_sparse_updat_matches_plain(cuda, bsize, dtype, kind):
    """bsmm_updat_sparse.cu over updat_sparse_plan's bundles on a conv-like
    layout (x 9 times dy's width, the taps of an input block bundled), the
    same with an x block-row emptied, and with one filled, at N 1, 77,
    2048 unsplit or split as updat_splits says and 4096 split: against the
    plain version at UPDAT_TOL and against bsmm_updat_mma.cu, two runs
    equal bit for bit, one launch a call on its counter."""
    layout = _tap_layout(4, 6, 0.3, seed=bsize)
    if kind == "empty_row":
        layout[5, :] = 0
    elif kind == "full_row":
        layout[4, :] = 1
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                              impl="xla")
    plan = op._plan("updat_sparse", "u")
    assert plan["by_c"] and plan["R"] in bsmm_kernels.UPDAT_SP_BUNDLES[bsize]
    g = torch.Generator(device=cuda).manual_seed(bsize)
    for N in (1, 77, 2048, 4096):
        x = torch.randn((N, op.C), device=cuda, generator=g).to(dtype)
        dy = torch.randn((N, op.K), device=cuda, generator=g).to(dtype)
        before = (bsmm_kernels.bsmm_updat.launches_sparse,
                  bsmm_kernels.bsmm_updat.launches_wgmma)
        (dw, splits), (again, _) = (_sparse_updat(op, x, dy, cuda)
                                    for _ in range(2))
        torch.cuda.synchronize()
        assert (splits > 1) == (N >= 1024)
        assert (bsmm_kernels.bsmm_updat.launches_sparse,
                bsmm_kernels.bsmm_updat.launches_wgmma) == \
            (before[0] + 2, before[1])
        assert torch.equal(dw, again)
        ref = plain._updat(x, dy)
        assert dw.dtype == torch.float32 and dw.shape == op.w_shape
        atol = UPDAT_TOL * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(dw, ref, rtol=0, atol=atol)
        mma, _ = _sparse_updat(op, x, dy, cuda, "mma")
        torch.testing.assert_close(dw, mma, rtol=0, atol=atol)


@pytest.mark.cuda
def test_sparse_updat_takes_the_narrower_operand_in_its_slots(cuda):
    """The transposed conv-like layout (dy the wider operand): dy's
    block-columns bundled and shared, x in the slots (dw transposed back
    in the epilogue), against the plain version."""
    layout = _tap_layout(3, 4, 0.4, seed=3).T.copy()
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=32, feature_axis=1,
                              impl="xla")
    assert not op._plan("updat_sparse", "u")["by_c"]
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((1000, op.C), device=cuda, generator=g).bfloat16()
    dy = torch.randn((1000, op.K), device=cuda, generator=g).bfloat16()
    dw, _ = _sparse_updat(op, x, dy, cuda)
    ref = plain._updat(x, dy)
    torch.testing.assert_close(
        dw, ref, rtol=0, atol=UPDAT_TOL * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
def test_conv_backward_routes_its_updat_to_the_sparse_kernel(cuda):
    """BlocksparseConv at C = K = 1024 (b32, d 0.25, 3x3 SAME, batch 2 of
    32x32: N 2048): kernel_of names bsmm_updat_sparse.cu for the updat, a
    forward + backward launches it once (and no other updat kernel), and
    dF matches the plain conv's."""
    C, b = 1024, 32
    rng = np.random.RandomState(0)
    BCK = [(tuple(range(cb * b, (cb + 1) * b)), tuple(range(kb * b,
                                                            (kb + 1) * b)))
           for kb in range(C // b) for cb in range(C // b)
           if cb == kb or rng.rand() < 0.25]
    kw = dict(padding="SAME", impl="bsmm")
    port = BlocksparseConv(BCK, (3, 3), (32, 32), **kw)
    plain = BlocksparseConv(BCK, (3, 3), (32, 32), bsmm_impl="xla", **kw)
    assert port._bsmm_op.kernel_of(2 * 32 * 32, "u") == "bsmm_updat_sparse"
    F = torch.tensor(random_jax_conv_filter(port, seed=1),
                     device=cuda).bfloat16()
    g = torch.Generator(device=cuda).manual_seed(4)
    x = (torch.rand((2, C, 32, 32), device=cuda, generator=g) * 2
         - 1).bfloat16()
    u = bsmm_kernels.bsmm_updat
    before = (u.launches, u.launches_sparse)
    dF = _conv_fwd_grads(port, F, x)[2]
    torch.cuda.synchronize()
    assert (u.launches, u.launches_sparse) == (before[0] + 1, before[1] + 1)
    ref = _conv_fwd_grads(plain, F, x)[2]
    torch.testing.assert_close(
        dF.float(), ref.float(), rtol=0,
        atol=BSMM_BF16_TOL * max(1.0, ref.float().abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("bsize,xk", [(32, "sparse"), (64, "wgmma")])
def test_wgmma_kernels_feature_axis_0_and_graph_replay(cuda, bsize, xk):
    """The op at feature_axis 0 on the wgmma kernels (bf16, N filling the
    card; the xprop on bsmm_xprop_sparse.cu at b32, its weights packed a
    call, on bsmm_xprop_wgmma.cu at b64; the updat on bsmm_updat_sparse.cu
    at b32, on bsmm_updat_wgmma.cu at b64): y, dx and dw against the plain
    op; then the three products captured into a CUDA graph (the tensor
    maps encoded at capture hold the captured tensors' addresses) and
    replayed on new inputs copied into those tensors, equal bit for bit
    to the eager calls."""
    layout = random_layout(128 // bsize, 192 // bsize, 0.9, seed=8)
    port = BlocksparseMatMul(layout, block_size=bsize, feature_axis=0)
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=0,
                              impl="xla")
    N = 128 * bsmm_kernels.device_sm_count(cuda) + 7
    assert [port.kernel_of(N, d) for d in "fbu"] == [
        f"bsmm_xprop_{xk}", f"bsmm_xprop_{xk}", f"bsmm_updat_{xk}"]
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(port.i_shape(N), device=cuda, generator=g).bfloat16()
    w = (torch.randn(port.w_shape, device=cuda, generator=g) * 0.1).bfloat16()
    dy = torch.randn(port.o_shape(N), device=cuda, generator=g).bfloat16()

    def products():
        return (port._xprop(x, w, "f"), port._xprop(dy, w, "b"),
                port._updat(x, dy))
    eager = products()
    for got, ref, tol in zip(eager, (plain._xprop(x, w, "f"),
                                     plain._xprop(dy, w, "b"),
                                     plain._updat(x, dy)),
                             (BSMM_BF16_TOL, BSMM_BF16_TOL, UPDAT_TOL)):
        torch.testing.assert_close(
            got.float(), ref.float(), rtol=0,
            atol=tol * max(1.0, ref.float().abs().max().item()))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        products()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = products()
    for t in (x, w, dy):
        t.copy_(torch.randn(t.shape, device=cuda, generator=g) * 0.5)
    graph.replay()
    torch.cuda.synchronize()
    for got, ref in zip(captured, products()):
        assert torch.equal(got, ref)


def _sparse_layout(seed):
    """Three b32 column groups of 8 (the last short: 19 output
    block-columns) over 13 input blocks (an odd count: the last pair's
    second half past C), random at 0.3, output column 2 and input
    block-row 2 empty."""
    layout = random_layout(13, 19, 0.3, seed=seed)
    layout[:, 2] = 0
    layout[2, :] = 0
    return layout


@pytest.mark.cuda
@pytest.mark.parametrize("d", ["f", "b"])
@pytest.mark.parametrize("dtype", HALF)
def test_sparse_xprop_matches_plain_and_wgmma(cuda, dtype, d):
    """bsmm_xprop_sparse.cu over xprop_sparse_plan's items (pairs of input
    blocks) at N 1, 5, 300 and a tile plus one (129): against the plain
    version at the matmul's bf16 tolerance, equal bit for bit to
    bsmm_xprop_wgmma.cu (the same sums in the same order) and to itself
    on a second run, the empty column exactly zero; one launch a call
    counted on the direction's sparse counter, one packing of the
    weights, equal bit for bit to its plain version."""
    layout = _sparse_layout(seed=4 + (d == "b"))
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=32, feature_axis=1,
                              impl="xla")
    lut = op._lut(cuda)
    plan = op._plan_tensors(cuda, "sparse", d)
    wplan = op._plan_tensors(cuda, "wgmma", d)
    kern = bsmm_kernels.bsmm_bprop if d == "b" else bsmm_kernels.bsmm_fprop
    n_out = op.KB if d == "f" else op.CB
    csr = (lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"], lut[f"{d}_ent_w"], 32,
           n_out)
    g = torch.Generator(device=cuda).manual_seed(6)
    w = (torch.randn(op.w_shape, device=cuda, generator=g) * 0.2).to(dtype)
    assert torch.equal(
        bsmm_kernels.xprop_sparse_pack(w, plan["w_order"], 32),
        bsmm_kernels.xprop_sparse_pack_plain(w, plan["w_order"], 32))
    for N in (1, 5, 300, bsmm_kernels.XPROP_WG_TM + 1):
        x = torch.randn((N, op.C if d == "f" else op.K), device=cuda,
                        generator=g).to(dtype)
        before = (kern.launches, kern.launches_sparse,
                  bsmm_kernels.xprop_sparse_pack.launches)
        y, again = (kern(x, w, *csr, plan=plan) for _ in range(2))
        torch.cuda.synchronize()
        assert (kern.launches, kern.launches_sparse,
                bsmm_kernels.xprop_sparse_pack.launches) == \
            (before[0] + 2, before[1] + 2, before[2] + 2)
        assert torch.equal(y, again)
        assert torch.equal(y, kern(x, w, *csr, plan=wplan))
        assert y.dtype == dtype and y.shape == (N, n_out * 32)
        ref = plain._xprop(x, w, d).float()
        torch.testing.assert_close(
            y.float(), ref, rtol=0,
            atol=_tol(dtype, BSMM_BF16_TOL, ref.abs().max().item()))
        assert (y[:, 2 * 32:3 * 32] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", ["f", "b"])
def test_sparse_xprop_spreads_a_non_finite_input(cuda, d):
    """An infinity in x at one input block (bf16): the plain version and
    bsmm_xprop_wgmma.cu make its row non-finite in the output columns
    with an entry at that block; bsmm_xprop_sparse.cu also, as NaN, in
    the columns paired with one of those that have none (the pair's zero
    block times the infinity: it never hides a non-finite input, it
    spreads it); every other output equal bit for bit to the call
    without the infinity."""
    from test_torch_bsmm_wgmma_plan import non_finite_block, \
        non_finite_columns
    layout = _sparse_layout(seed=11 + (d == "b"))
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    plain = BlocksparseMatMul(layout, block_size=32, feature_axis=1,
                              impl="xla")
    i, reads, partners = non_finite_block(op, d)
    lut = op._lut(cuda)
    kern = bsmm_kernels.bsmm_bprop if d == "b" else bsmm_kernels.bsmm_fprop
    csr = (lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"], lut[f"{d}_ent_w"], 32,
           op.KB if d == "f" else op.CB)
    plan, wplan = (op._plan_tensors(cuda, k, d) for k in ("sparse", "wgmma"))
    g = torch.Generator(device=cuda).manual_seed(11)
    w = (torch.randn(op.w_shape, device=cuda, generator=g) * 0.2).bfloat16()
    x = torch.randn((300, op.C if d == "f" else op.K), device=cuda,
                    generator=g).bfloat16()
    clean = kern(x, w, *csr, plan=plan)
    x[3, i * 32 + 5] = float("inf")
    y = kern(x, w, *csr, plan=plan)
    assert non_finite_columns(plain._xprop(x, w, d), 3) == reads
    assert non_finite_columns(kern(x, w, *csr, plan=wplan), 3) == reads
    assert non_finite_columns(y, 3) == reads | partners
    assert torch.isnan(y[3].reshape(-1, 32)[sorted(partners)]).all()
    keep = torch.ones_like(y, dtype=torch.bool)
    for c in reads | partners:
        keep[3, c * 32:(c + 1) * 32] = False
    assert torch.equal(y[keep], clean[keep])


@pytest.mark.cuda
def test_sparse_kernel_info_shows_no_local_memory(cuda):
    """Every instantiation of bsmm_xprop_sparse.cu's kernel (bf16 and f16,
    fprop and bprop) holds its registers without spilling and is
    resident, one thread block an SM, its ring at least 3 slots."""
    for dtype in HALF:
        for trans in (False, True):
            info = bsmm_kernels.sparse_kernel_info(dtype, trans)
            assert info["local_bytes"] == 0, (dtype, trans, info)
            assert info["blocks_per_sm"] == 1 and info["stages"] >= 3
            assert info["smem_bytes"] <= 232448


@pytest.mark.cuda
def test_sparse_wrappers_raise(cuda):
    """The sparse kernel's wrappers refuse a CPU tensor, f32, block sizes
    other than 32 (its plan too) and an empty N; its packing refuses f32
    weights and block ids of another dtype."""
    op = BlocksparseMatMul(_sparse_layout(seed=9), block_size=32,
                           feature_axis=1)
    lut, plan = op._lut(cuda), op._plan_tensors(cuda, "sparse", "f")
    csr = (lut["f_row_ptr"], lut["f_ent_in"], lut["f_ent_w"], 32, op.KB)
    x = torch.randn((64, op.C), device=cuda).bfloat16()
    w = torch.randn(op.w_shape, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(x.cpu(), w.cpu(), *csr, plan=plan)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_fprop(x.float(), w.float(), *csr, plan=plan)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(x[:0], w, *csr, plan=plan)
    with pytest.raises(ValueError):
        bsmm_kernels.xprop_sparse_plan([0, 1], [0], [0], 64)
    with pytest.raises(ValueError):
        bsmm_kernels.xprop_sparse_pack(w.float(), plan["w_order"], 32)
    with pytest.raises(ValueError):
        bsmm_kernels.xprop_sparse_pack(w, plan["w_order"].int(), 32)


@pytest.mark.cuda
def test_wgmma_wrappers_raise(cuda):
    """The wgmma wrappers refuse a CPU tensor, mixed dtypes, f32, a block
    size they are not built for and an empty N; the updat refuses an
    unknown kernel name."""
    layout = random_layout(4, 6, 0.5, seed=9)
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=1)
    lut, plan = op._lut(cuda), op._plan_tensors(cuda, "wgmma", "f")
    csr = (lut["f_row_ptr"], lut["f_ent_in"], lut["f_ent_w"], 32, op.KB)
    x = torch.randn((64, op.C), device=cuda).bfloat16()
    w = torch.randn(op.w_shape, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(x.cpu(), w.cpu(), *csr, plan=plan)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_fprop(x, w.half(), *csr, plan=plan)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_fprop(x.float(), w.float(), *csr, plan=plan)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(x[:0], w, *csr, plan=plan)
    small = BlocksparseMatMul(random_layout(4, 6, 0.5, seed=9), block_size=16,
                              feature_axis=1)
    slut = small._lut(cuda)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fprop(
            torch.randn((64, small.C), device=cuda).bfloat16(),
            torch.randn(small.w_shape, device=cuda).bfloat16(),
            slut["f_row_ptr"], slut["f_ent_in"], slut["f_ent_w"], 16,
            small.KB, plan=small._plan_tensors(cuda, "wgmma", "f"))
    uplan = op._plan_tensors(cuda, "updat", "u")
    dy = torch.randn((64, op.K), device=cuda).bfloat16()
    ents = (lut["u_c32"], lut["u_k32"], 32, uplan, 1)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_updat(x.cpu(), dy.cpu(), *ents, "wgmma")
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_updat(x, dy.half(), *ents, "wgmma")
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_updat(x.float(), dy.float(), *ents, "wgmma")
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_updat(x, dy, *ents, "tma")
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_updat(x[:0], dy[:0], *ents, "wgmma")


def _grouped_layout(bsize):
    """An n x n layout, n = 3·gn + 1 (gn = 128 / b columns a group of
    bsmm_fprop.cu), full but for an empty block-row 2 and block-column 2:
    every other output column, fprop and bprop, holds the same entry list,
    so xprop_groups fills three whole groups and puts the empty column in a
    fourth."""
    n = 3 * max(1, bsmm_kernels.XPROP_F32_COLS // bsize) + 1
    layout = np.ones((n, n), np.int32)
    layout[2, :] = 0
    layout[:, 2] = 0
    return layout


F32_LAYOUTS = {
    "grouped": _grouped_layout,
    "sparse": lambda b: random_layout(6, 5, 0.4, seed=b),
    "one block wide": lambda b: np.ones((5, 1), np.int32),
    "one block tall": lambda b: np.ones((1, 5), np.int32)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fprop", "bprop", "partials"])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_f32_xprop_every_tile_and_grouping_agrees(cuda, bsize, route):
    """bsmm_fprop.cu in f32 at N 1, 4, 77 and 300 (none a multiple of an
    N-tile) on a layout whose columns group, a sparse one, and layouts one
    block wide and one block tall: in both configurations the kernel is
    built for (full column groups, one column a thread block), the one the
    op picks, and one column a thread block in index order, the same bits,
    twice; within 1e-5 of the plain version; an empty column exactly zero;
    no plan raises.  partials: the split route's tiles (8 runs at most),
    merged by merge_plain (fprop and bprop)."""
    g = torch.Generator(device=cuda).manual_seed(bsize)
    for kind, make in F32_LAYOUTS.items():
        layout = make(bsize)
        op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
        plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                                  impl="xla")
        lut = op._lut(cuda)
        w = torch.randn(op.w_shape, device=cuda, generator=g)
        for d in ("fb" if route == "partials" else route[0]):
            trans = d == "b"
            ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
            phases = 8 if route == "partials" else 0
            if route == "partials":
                split = op._plan_tensors(cuda, "split", d, 8)
                ptr = split["tile_ptr"]
                n_out = ptr.numel() - 1
            else:
                ptr, n_out = lut[f"{d}_row_ptr"], (op.KB, op.CB)[trans]
            plan = op._plan_tensors(cuda, "xgroup", d, phases)
            if kind == "grouped":
                assert plan["gn"] == max(1, 128 // bsize)
            launches = [bsmm_kernels.xprop_launch(plan, t)
                        for t in bsmm_kernels.xprop_f32_tiles(bsize)
                        if t[0] == 1 or t[0] == plan["gn"]]
            launches.append({"grp_col": torch.arange(
                n_out, dtype=torch.int32, device=cuda)[:, None],
                "gn": 1, "tm": bsmm_kernels.XPROP_F32_TM})
            width = op.C if d == "f" else op.K
            for N in (1, 4, 77, 300):
                x = torch.randn((N, width), device=cuda, generator=g)

                def run(pl):
                    if route == "partials":
                        return bsmm_kernels.bsmm_partials(
                            x, w, ptr, *ents, bsize, n_out, trans, plan=pl)
                    kernel = bsmm_kernels.bsmm_bprop if trans \
                        else bsmm_kernels.bsmm_fprop
                    return kernel(x, w, ptr, *ents, bsize, n_out, plan=pl)
                y = run(op._xlaunch(cuda, d, N, phases))
                for pl in launches:
                    assert torch.equal(run(pl), y), \
                        (kind, d, N, pl["gn"], pl["tm"])
                assert torch.equal(run(launches[0]), y)
                with pytest.raises(ValueError):
                    run(None)
                if route == "partials":
                    y = bsmm_kernels.merge_plain(y, split["merge_idx"].long(),
                                                 bsize)
                ref = plain._xprop(x, w, d)
                torch.testing.assert_close(
                    y, ref, rtol=0,
                    atol=F32_TOL * max(1.0, ref.abs().max().item()))
                if kind == "grouped":
                    assert (y[:, 2 * bsize:3 * bsize] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_f32_updat_tails_and_narrow_layouts(cuda, bsize):
    """bsmm_updat.cu at N 1, 4 and 77 on the layouts of the xprop test
    above and their transposes (groups by x block-row and by dy
    block-column, a group of one or two blocks): two runs equal bit for
    bit, within 1e-4 of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(bsize)
    for kind, make in F32_LAYOUTS.items():
        for layout in (make(bsize), make(bsize).T.copy()):
            op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
            plain = BlocksparseMatMul(layout, block_size=bsize,
                                      feature_axis=1, impl="xla")
            for N in (1, 4, 77):
                x = torch.randn((N, op.C), device=cuda, generator=g)
                dy = torch.randn((N, op.K), device=cuda, generator=g)
                dw = op._updat(x, dy)
                assert torch.equal(op._updat(x, dy), dw), (kind, N)
                ref = plain._updat(x, dy)
                torch.testing.assert_close(
                    dw, ref, rtol=0,
                    atol=UPDAT_TOL * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
def test_f32_sources_refuse_half_and_report_their_tiles(cuda):
    """bsmm_fprop.cu and bsmm_updat.cu take f32 only (bf16 and f16:
    cudaErrorInvalidValue), and neither a (group width, N-tile) they are
    not built for nor a null column list; every configuration they are
    built for fits on the card (one thread block an SM at least), as their
    info functions report."""
    from blocksparse_tpu_torch.kernels import _build
    layout = random_layout(4, 4, 1.0, seed=0)
    op = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    lut = op._lut(cuda)
    up = op._plan_tensors(cuda, "updat", "u")
    x = torch.randn((4, op.C), device=cuda)
    y = torch.empty((4, op.K), device=cuda)
    xprop = _build.function("bsmm_fprop", "bsmm_xprop_nc",
                            bsmm_kernels._xprop_args(4, 3))
    cols = torch.arange(op.KB, dtype=torch.int32, device=cuda)
    args = (x.data_ptr(), x.data_ptr(), lut["f_row_ptr"].data_ptr(),
            lut["f_ent_in"].data_ptr(), lut["f_ent_w"].data_ptr(),
            cols.data_ptr(), y.data_ptr(), 4, op.C, op.K, op.KB)
    s = bsmm_kernels._stream(x)
    for code, gn, tm in ((1, 1, 32), (2, 1, 32), (0, 1, 16), (0, 2, 32),
                         (0, 1, 64), (0, 1, 128), (0, 8, 32)):
        assert xprop(code, 16, 0, *args, gn, tm, s) == 1, (code, gn, tm)
    null = args[:5] + (0,) + args[6:]
    assert xprop(0, 16, 0, *null, 1, 32, s) == 1
    assert xprop(0, 16, 0, *args, 1, 32, s) == 0
    updat = _build.function("bsmm_updat", "bsmm_updat_nc",
                            bsmm_kernels._UPDAT_ARGS)
    for code in (1, 2):
        assert updat(code, 16, int(up["by_c"]), x.data_ptr(), x.data_ptr(),
                     up["grp_q"].data_ptr(), up["slot_p"].data_ptr(),
                     up["slot_e"].data_ptr(), y.data_ptr(), 4, op.C, op.C,
                     up["grp_q"].numel(), s) == 1
    torch.cuda.synchronize()
    info = (ctypes.c_int * 5)()
    ptr = ctypes.cast(info, ctypes.c_void_p)
    xinfo = _build.function("bsmm_fprop", "bsmm_xprop_nc_info",
                            [ctypes.c_int] * 4 + [ctypes.c_void_p])
    uinfo = _build.function("bsmm_updat", "bsmm_updat_nc_info",
                            [ctypes.c_int] * 2 + [ctypes.c_void_p])
    for b in bsmm_kernels.BLOCK_SIZES:
        for trans in (0, 1):
            for gn, tm in bsmm_kernels.xprop_f32_tiles(b):
                assert xinfo(b, trans, gn, tm, ptr) == 0
                assert info[0] > 0 and info[4] >= 1, (b, trans, gn, tm)
            assert uinfo(b, trans, ptr) == 0
            assert info[0] > 0 and info[4] >= 1, (b, trans)


def _case(device, dtype, bs, hs, layout=None, mask_callback=None, heads=2,
          batch=2, seed=0):
    layout = fixed_layout(4, local_blocks=2) if layout is None else layout
    ctx = layout.shape[-1] * bs
    port = BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=mask_callback
                                  or causal_subblock_mask)
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((batch, ctx, 3 * heads * hs), device=device,
                      generator=g).to(dtype)
    do = torch.randn((batch, ctx, heads * hs), device=device,
                     generator=g).to(dtype)
    return port, qkv.split(heads * hs, dim=-1), do


def _plain_fwd_bwd(port, q, k, v, do, scale):
    tab = port._tables(q.device)
    args = (tab["q_blk"], tab["k_blk"], tab["mask"], port.heads,
            port.blk_size, scale)
    out, lse = bst_attn.attention_fwd_lse_plain(q, k, v, *args)
    batch, ctx, state = q.shape
    dvec = (do.float() * out.float()).reshape(
        batch, ctx, port.heads, -1).sum(-1).transpose(1, 2).contiguous()
    return out, lse, dvec, bst_attn.attention_bwd_plain(q, k, v, do, lse,
                                                        dvec, *args)


def _kernel_bwd(port, q, k, v, do, lse, dvec, scale, ordered=True, tab=None):
    """dq and (dk, dv) on the kernels; dk/dv with the tables' launch order
    of the key rows, or in CSR order (``ordered=False``)."""
    tab = port._tables(q.device) if tab is None else tab
    if not ordered:
        tab = _csr_order(tab)
    dq = bst_attn.attention_dq(q, k, v, do, lse, dvec, tab, port.heads,
                               scale)
    dk, dv = bst_attn.attention_dkv(q, k, v, do, lse, dvec, tab, port.heads,
                                    scale)
    return dq, dk, dv


# (bs, hs, dtype, block-rows of the fixed layout, its local blocks): f32 at
# four shapes (bst_attn_bwd.cu), bf16 and f16 at every (bs, hs) the kernels
# take (bst_attn_bwd_mma.cu), and the LM's (64, 64) on its 32-block-row
# layout, whose summary key rows hold up to 32 entries.
ATTN_TRAIN_CASES = (
    [(bs, hs, torch.float32, 4, 2)
     for bs, hs in ((16, 16), (32, 128), (64, 64), (64, 32))]
    + [(bs, hs, dtype, 4, 2) for dtype in HALF
       for bs in bst_attn.BLOCK_SIZES for hs in bst_attn.HEAD_SIZES]
    + [(64, 64, dtype, 32, 8) for dtype in HALF])


@pytest.mark.cuda
@pytest.mark.parametrize("bs,hs,dtype,blocks,local", ATTN_TRAIN_CASES)
def test_attention_train_kernels_match_plain(cuda, bs, hs, dtype, blocks,
                                             local):
    """fwd_lse (out and lse), dq and dk/dv against the plain versions on the
    same dO, lse and D; q/k/v are strided column slices of one qkv."""
    port, (q, k, v), do = _case(
        cuda, dtype, bs, hs, layout=fixed_layout(blocks, local_blocks=local))
    scale = 1.0 / np.sqrt(hs)
    tab = port._tables(cuda)
    out_ref, lse_ref, dvec, (dq_ref, dk_ref, dv_ref) = _plain_fwd_bwd(
        port, q, k, v, do, scale)
    out, lse = bst_attn.attention_fwd_lse(q, k, v, tab, port.heads, scale)
    dq, dk, dv = _kernel_bwd(port, q, k, v, do, lse_ref, dvec, scale)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and dk.dtype == dv.dtype == torch.float32
    assert dq.dtype == dtype
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for got, ref in ((out, out_ref), (dq, dq_ref), (dk, dk_ref),
                     (dv, dv_ref)):
        ref = ref.float()
        torch.testing.assert_close(
            got.float(), ref, rtol=0,
            atol=_tol(dtype, ATTN_BF16_TOL, ref.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("kind", ["per_head", "f1", "dense"])
def test_attention_train_kernels_masks(cuda, kind, dtype):
    """Per-head layouts, a fully masked query row (zero out, lse -inf, zero
    dq, no dk/dv contribution, no NaN) and a dense causal layout with the
    causal sub-block mask (TRIL on the query rows, TRIU on the key rows),
    in f32 (CUDA cores) and in bf16 and f16 (tensor cores)."""
    lay = fixed_layout(4, local_blocks=2)
    layout, mask, heads = lay, None, 2
    if kind == "per_head":
        layout, heads = np.stack([lay, lay[:, ::-1], lay, np.flipud(lay)]), 4
    elif kind == "f1":
        layout, mask = np.tril(np.ones((4, 4), np.int32)), _f1_mask
    elif kind == "dense":
        layout = np.tril(np.ones((6, 6), np.int32))
    port, (q, k, v), do = _case(cuda, dtype, 16, 32, layout=layout,
                                mask_callback=mask, heads=heads, seed=4)
    out_ref, lse_ref, dvec, refs = _plain_fwd_bwd(port, q, k, v, do, 0.3)
    tab = port._tables(cuda)
    out, lse = bst_attn.attention_fwd_lse(q, k, v, tab, heads, 0.3)
    got = _kernel_bwd(port, q, k, v, do, lse, dvec, 0.3)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), out_ref.float(), rtol=0,
        atol=F32_TOL if dtype == torch.float32 else
        ATTN_BF16_TOL * max(1.0, out_ref.float().abs().max().item()))
    torch.testing.assert_close(lse, lse_ref, rtol=0,
                               atol=1e-5 if dtype == torch.float32 else 1e-4)
    for g, r in zip(got, refs):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(
            g.float(), r.float(), rtol=0,
            atol=_tol(dtype, ATTN_BF16_TOL, r.float().abs().max().item()))
    if kind == "f1":
        dead = 16 + 3
        assert (out[:, dead] == 0).all() and (got[0][:, dead] == 0).all()
        assert torch.isinf(lse[:, :, dead]).all()
        do0 = do.clone()
        do0[:, dead] = 0
        dvec0 = dvec.clone()
        dvec0[:, :, dead] = 0
        _, dk0, dv0 = _kernel_bwd(port, q, k, v, do0, lse, dvec0, 0.3)
        torch.testing.assert_close(dk0, got[1], rtol=0, atol=0)
        torch.testing.assert_close(dv0, got[2], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_attention_bwd_kernels_bit_equal(cuda, dtype):
    """Two runs of dq and of dk/dv give the same bits (every sum in the CSR
    order, no atomics), on the CUDA cores (f32) and on the tensor cores
    (bf16, f16), and the launch order of the key rows changes none of
    them; at the LM's bs 64 / hs 64 on a 16-block-row fixed layout."""
    port, (q, k, v), do = _case(cuda, dtype, 64, 64,
                                layout=fixed_layout(16, local_blocks=4))
    _, lse, dvec, _ = _plain_fwd_bwd(port, q, k, v, do, 0.125)
    first = _kernel_bwd(port, q, k, v, do, lse, dvec, 0.125)
    again = _kernel_bwd(port, q, k, v, do, lse, dvec, 0.125)
    csr = _kernel_bwd(port, q, k, v, do, lse, dvec, 0.125, ordered=False)
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, csr):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_attention_bwd_source_by_dtype(cuda, monkeypatch):
    """f32 launches bst_attn_bwd.cu, bf16 and f16 bst_attn_bwd_mma.cu; each
    source refuses the other's dtypes (cudaErrorInvalidValue)."""
    from blocksparse_tpu_torch.kernels import _build
    used = []
    build_fn = _build.function

    def spy(name, fn_name, argtypes):
        used.append((name, fn_name))
        return build_fn(name, fn_name, argtypes)
    monkeypatch.setattr(_build, "function", spy)
    for dtype in (torch.float32, *HALF):
        port, (q, k, v), do = _case(cuda, dtype, 16, 32)
        _, lse, dvec, _ = _plain_fwd_bwd(port, q, k, v, do, 0.3)
        used.clear()
        _kernel_bwd(port, q, k, v, do, lse, dvec, 0.3)
        lib = "bst_attn_bwd" if dtype == torch.float32 else "bst_attn_bwd_mma"
        assert used == [(lib, lib)] * 2
    tab = port._tables(cuda)
    out = torch.empty(q.shape, dtype=torch.float32, device=cuda)
    strides = (ctypes.c_longlong * 8)(*(
        s for t in (q, k, v, do) for s in t.stride()[:2]))
    for lib, codes in (("bst_attn_bwd", (1, 2)), ("bst_attn_bwd_mma", (0,))):
        fn = build_fn(lib, lib, bst_attn._BWD_ARGS)
        for code in codes:
            for which in (0, 1):
                assert fn(code, which, 16, 32, q.data_ptr(), k.data_ptr(),
                          v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          dvec.data_ptr(), out.data_ptr(), out.data_ptr(),
                          ctypes.addressof(strides),
                          tab["row_ptr"].data_ptr(), tab["ent_k"].data_ptr(),
                          tab["ent_code"].data_ptr(), tab["uniq"].data_ptr(),
                          None, 2, port.heads, 1, 4, 4, 0.3,
                          torch.cuda.current_stream().cuda_stream) == 1, \
                    (lib, code, which)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_attention_bwd_unaligned_views(cuda, dtype):
    """q, k, v and dO that start off a 16-byte boundary, or whose row
    stride is off 16 bytes, give the same dq, dk and dv as their
    contiguous copies (the wrapper hands the tensor-core kernels an
    aligned copy)."""
    port, (q, k, v), do = _case(cuda, dtype, 32, 16)
    _, lse, dvec, _ = _plain_fwd_bwd(port, q, k, v, do, 0.25)
    want = _kernel_bwd(port, *(t.contiguous() for t in (q, k, v, do)), lse,
                       dvec, 0.25)

    def shifted(t):      # starts 2 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)[1:]
        return buf.view_as(t).copy_(t)

    def padded(t):       # rows 2 elements wider than the data: 4 bytes off
        buf = torch.zeros(t.shape[:-1] + (t.shape[-1] + 2,), dtype=dtype,
                          device=cuda)
        return buf[..., :t.shape[-1]].copy_(t)
    for move in (shifted, padded):
        views = [move(t) for t in (q, k, v, do)]
        assert all(t.data_ptr() % 16 or t.stride(1) * t.element_size() % 16
                   for t in views)
        got = _kernel_bwd(port, *views, lse, dvec, 0.25)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), move.__name__


# ---------------- the wgmma attention kernels (bs 64)

def _wgmma_attn_layout(kind):
    """(layout, mask callback) of a wgmma attention case, each at least
    FWD_WGMMA_MIN_KEY_BLOCKS key block-rows (the forward's route): the
    LM's fixed layout (query rows 1-14 entries, key rows 1-32), an odd
    number of block-rows (one pair half empty), a fully masked query row
    (F1), and per-head layouts."""
    if kind == "lm":
        return fixed_layout(32, local_blocks=8), causal_subblock_mask
    if kind == "odd":
        return fixed_layout(17, local_blocks=2), causal_subblock_mask
    if kind == "f1":
        return np.tril(np.ones((16, 16), np.int32)), _f1_mask
    lay = fixed_layout(16, local_blocks=3)
    return np.stack([lay, lay[:, ::-1]]), causal_subblock_mask


def _wgmma_counts():
    return tuple(f.launches_wgmma for f in (bst_attn.attention_fwd,
                                            bst_attn.attention_fwd_lse,
                                            bst_attn.attention_dkv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("kind", ["lm", "odd", "f1", "per_head"])
def test_wgmma_attention_matches_plain(cuda, kind, hs, dtype):
    """The forward (serving and lse) on bst_attn_fwd_wgmma.cu and dk/dv on
    bst_attn_dkv_wgmma.cu (hs 64; hs 128 runs bst_attn_bwd_mma.cu by the
    route rule) against the plain versions, q/k/v column slices of one
    packed qkv; the launches counted on the wgmma kernels; two runs equal
    bit for bit; the F1 row zero with lse -inf and zero dq."""
    layout, cb = _wgmma_attn_layout(kind)
    port, (q, k, v), do = _case(cuda, dtype, 64, hs, layout=layout,
                                mask_callback=cb, seed=hs)
    scale = 1.0 / np.sqrt(hs)
    out_ref, lse_ref, dvec, refs = _plain_fwd_bwd(port, q, k, v, do, scale)
    dkv_wgmma = bst_attn.attn_kernel("dkv", dtype, 64, hs,
                                     layout.shape[-1]).endswith("wgmma")
    before = _wgmma_counts()
    serve, out, lse = _kernel_fwd(port, q, k, v, scale)
    grads = _kernel_bwd(port, q, k, v, do, lse_ref, dvec, scale)
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_wgmma_counts(), before))
    assert moved == (1, 1, int(dkv_wgmma))
    assert torch.equal(serve, out)
    tol = _fwd_tol(dtype, out_ref)
    torch.testing.assert_close(out.float(), out_ref.float(), rtol=0, atol=tol)
    live = torch.isfinite(lse_ref)
    assert torch.equal(live, torch.isfinite(lse))
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=0, atol=1e-4)
    for g, r in zip(grads, refs):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(
            g.float(), r.float(), rtol=0,
            atol=_tol(dtype, ATTN_BF16_TOL, r.float().abs().max().item()))
    again = _kernel_fwd(port, q, k, v, scale)[1:] + \
        _kernel_bwd(port, q, k, v, do, lse_ref, dvec, scale)[1:]
    for a, b in zip((out, lse) + grads[1:], again):
        assert torch.equal(a, b)
    if kind == "f1":
        dead = 64 + 3
        assert (out[:, dead] == 0).all() and (grads[0][:, dead] == 0).all()
        assert torch.isneginf(lse[:, :, dead]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_wgmma_attention_negative_and_zero_scale(cuda, scale, dtype):
    """A negative scale (the wgmma forward flips the scores' sign, so its
    running max stays a max) and a zero scale (every visible key weighs
    the same; masked keys stay out) match the plain version at bs 64."""
    port, (q, k, v), do = _case(cuda, dtype, 64, 64,
                                layout=fixed_layout(16, local_blocks=3))
    out_ref, lse_ref, dvec, refs = _plain_fwd_bwd(port, q, k, v, do, scale)
    out, lse = _kernel_fwd(port, q, k, v, scale)[1:]
    grads = _kernel_bwd(port, q, k, v, do, lse_ref, dvec, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), out_ref.float(), rtol=0,
                               atol=_fwd_tol(dtype, out_ref))
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-4)
    for g, r in zip(grads[1:], refs[1:]):
        torch.testing.assert_close(
            g.float(), r.float(), rtol=0,
            atol=_tol(dtype, ATTN_BF16_TOL, r.float().abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
def test_wgmma_attention_graph_replay(cuda, dtype):
    """The wgmma forward and dk/dv captured into one CUDA graph: the
    replay equals the eager launches bit for bit, and after new values
    are copied into the captured inputs the replay equals the eager
    launches on them (the tensor maps hold the captured tensors)."""
    port, (q, k, v), do = _case(cuda, dtype, 64, 64,
                                layout=fixed_layout(16, local_blocks=3))
    tab, scale = port._tables(cuda), 0.125
    _, lse, dvec, _ = _plain_fwd_bwd(port, q, k, v, do, scale)

    def run():
        o, l = bst_attn.attention_fwd_lse(q, k, v, tab, port.heads, scale)
        return (o, l) + bst_attn.attention_dkv(q, k, v, do, lse, dvec, tab,
                                               port.heads, scale)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    for step in range(2):
        if step:
            with torch.no_grad():
                for t in (q, k, v, do):
                    t.mul_(-0.5)
        graph.replay()
        torch.cuda.synchronize()
        eager = run()
        torch.cuda.synchronize()
        for a, b in zip(static, eager):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_wgmma_attention_wrappers_raise(cuda):
    """At the wgmma kernels' shape the wrappers raise on CPU tensors, mixed
    dtypes, tables that lack the pair plan or lie on another device, and
    never fall back."""
    port, (q, k, v), do = _case(cuda, torch.bfloat16, 64, 64)
    tab = port._tables(cuda)
    with pytest.raises(ValueError, match="CUDA"):
        bst_attn.attention_fwd_lse(q.cpu(), k.cpu(), v.cpu(),
                                   port._tables("cpu"), port.heads, 0.125)
    with pytest.raises(TypeError):
        bst_attn.attention_fwd_lse(q, k.half(), v, tab, port.heads, 0.125)
    lse = torch.zeros((2, port.heads, q.shape[1]), device=cuda)
    with pytest.raises(TypeError):
        bst_attn.attention_dkv(q, k, v, do.half(), lse, lse, tab, port.heads,
                               0.125)
    partial = {n: t for n, t in tab.items() if n != "pair_ent"}
    with pytest.raises(KeyError, match="pair_ent"):
        bst_attn.attention_fwd(q, k, v, partial, port.heads, 0.125)
    cpu_plan = dict(tab, pair_ptr_t=tab["pair_ptr_t"].cpu())
    with pytest.raises(ValueError):
        bst_attn.attention_dkv(q, k, v, do, lse, lse, cpu_plan, port.heads,
                               0.125)
    info = bst_attn.wgmma_kernel_info("dkv", torch.bfloat16)
    assert info["blocks_per_sm"] >= 1 and info["stages"] >= 2


def _assert_dq_close(got, ref, atol):
    """got within atol of ref everywhere and within ATTN_NORM_TOL of it in
    norm."""
    got, ref = got.float(), ref.float()
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)
    rel = (got - ref).norm().item() / max(ref.norm().item(), 1e-30)
    assert rel <= ATTN_NORM_TOL, rel


def _dq_pair(q, k, v, do, lse, dvec, tab, heads, scale, monkeypatch,
             out_dtype=None):
    """dq on bst_attn_dq_wgmma.cu and on bst_attn_bwd_mma.cu (dq's wgmma
    head sizes emptied), each launch counted: (wgmma dq, mma.sync dq)."""
    def run():
        return bst_attn.attention_dq(q, k, v, do, lse, dvec, tab, heads,
                                     scale, out_dtype=out_dtype)
    f = bst_attn.attention_dq
    before = (f.launches, f.launches_wgmma)
    wg = run()
    with monkeypatch.context() as m:
        m.setattr(bst_attn, "DQ_WGMMA_HEAD_SIZES", ())
        mma = run()
    torch.cuda.synchronize()
    assert (f.launches, f.launches_wgmma) == (before[0] + 2, before[1] + 1)
    return wg, mma


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("kind", ["lm", "odd", "f1", "per_head"])
def test_wgmma_dq_matches_plain_and_mma(cuda, kind, hs, dtype, monkeypatch):
    """dq on bst_attn_dq_wgmma.cu (the route at bs 64, hs 64 and 128)
    against the plain version and against bst_attn_bwd_mma.cu's dq, in
    q's dtype and stored in f32 (which rounds to the former bit for bit),
    two runs equal bit for bit, the launches counted; the F1 row's dq
    zero."""
    layout, cb = _wgmma_attn_layout(kind)
    port, (q, k, v), do = _case(cuda, dtype, 64, hs, layout=layout,
                                mask_callback=cb, seed=hs + 1)
    scale = 1.0 / np.sqrt(hs)
    _, lse, dvec, refs = _plain_fwd_bwd(port, q, k, v, do, scale)
    tab = port._tables(cuda)
    assert bst_attn.attn_kernel("dq", dtype, 64, hs, layout.shape[-1]) == \
        "bst_attn_dq_wgmma"
    args = (q, k, v, do, lse, dvec, tab, port.heads, scale, monkeypatch)
    wg, mma = _dq_pair(*args)
    wg32, mma32 = _dq_pair(*args, out_dtype=torch.float32)
    ref32 = bst_attn.attention_bwd_plain(
        q, k, v, do, lse, dvec, tab["q_blk"], tab["k_blk"], tab["mask"],
        port.heads, 64, scale, dq_dtype=torch.float32)[0]
    atol = _tol(dtype, ATTN_BF16_TOL, refs[0].float().abs().max().item())
    assert wg.dtype == dtype and wg32.dtype == torch.float32
    assert torch.equal(wg32.to(dtype), wg)
    for got in (wg, mma):
        _assert_dq_close(got, refs[0], atol)
    for got in (wg32, mma32):
        _assert_dq_close(got, ref32, atol)
    _assert_dq_close(wg, mma, atol)
    assert torch.equal(wg, _dq_pair(*args)[0])
    if kind == "f1":
        assert (wg[:, 64 + 3] == 0).all() and (wg32[:, 64 + 3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("pair", [(3, None), (3, 3), (3, 0), (0, 3)])
def test_wgmma_dq_on_shard_tables(cuda, pair, dtype, monkeypatch):
    """dq on bst_attn_dq_wgmma.cu over sp-4 shard tables of the LM's layout
    at 16 block-rows (a gather shard: keys whole; ring pairs: one key
    chunk, (0, 3) with query rows that see no key) against the
    plain version and the mma.sync dq on the same tables, in q's dtype and
    in f32 (the ring's); rows that see no key store zeros."""
    from blocksparse_tpu_torch.parallel import sequence as seq
    n, (r, j) = 4, pair
    port = BlocksparseTransformer(fixed_layout(16, local_blocks=8),
                                  block_size=64, heads=2,
                                  mask_callback=causal_subblock_mask)
    tab = seq.shard_tables(port, n, r, j, cuda)
    L = 16 * 64 // n
    g = torch.Generator(device=cuda).manual_seed(r + 7)
    q, do = (torch.randn((2, L, 128), device=cuda, generator=g).to(dtype)
             for _ in range(2))
    ctx_k = 16 * 64 if j is None else L
    k, v = (torch.randn((2, ctx_k, 128), device=cuda, generator=g).to(dtype)
            for _ in range(2))
    scale = 0.125
    plain = (tab["q_blk"], tab["k_blk"], tab["mask"], 2, 64, scale)
    out, lse = bst_attn.attention_fwd_lse_plain(q, k, v, *plain)
    dvec = (do.float() * out.float()).reshape(2, L, 2, 64).sum(-1) \
        .transpose(1, 2).contiguous()
    dead = torch.isneginf(lse)                     # (batch, heads, L)
    assert dead.all() if pair == (0, 3) else not dead.any()
    for out_dtype in (None, torch.float32):
        ref = bst_attn.attention_bwd_plain(q, k, v, do, lse, dvec, *plain,
                                           dq_dtype=out_dtype)[0]
        wg, mma = _dq_pair(q, k, v, do, lse, dvec, tab, 2, scale,
                           monkeypatch, out_dtype=out_dtype)
        atol = _tol(dtype, ATTN_BF16_TOL, ref.float().abs().max().item())
        for got in (wg, mma):
            assert bool(torch.isfinite(got).all())
            _assert_dq_close(got, ref, atol)
        rows = dead.transpose(1, 2)[..., None].expand(2, L, 2, 64) \
            .reshape(2, L, 128)
        assert (wg[rows] == 0).all()


@pytest.mark.cuda
def test_wgmma_dq_kernel_info_shows_no_local_memory(cuda):
    """Every instantiation of bst_attn_dq_wgmma.cu (bf16 and f16, hs 64
    and 128, dq in the input type and in f32) holds its registers without
    spilling and is resident, one thread block an SM."""
    for dtype in HALF:
        for hs in (64, 128):
            for out in (None, torch.float32):
                info = bst_attn.wgmma_kernel_info("dq", dtype, hs, out)
                assert info["local_bytes"] == 0, (dtype, hs, out, info)
                assert info["blocks_per_sm"] == 1 and info["stages"] >= 2
                assert info["smem_bytes"] <= 232448


@pytest.mark.cuda
def test_attention_autograd_runs_train_kernels(cuda):
    port, (q0, k0, v0), do = _case(cuda, torch.bfloat16, 64, 64)
    counters = (bst_attn.attention_fwd, bst_attn.attention_fwd_lse,
                bst_attn.attention_dq, bst_attn.attention_dkv)
    grads = []
    for op in (port, _plain_twin(port)):
        q, k, v = (t.detach().clone().requires_grad_() for t in (q0, k0, v0))
        before = [c.launches for c in counters]
        op.attention(q, k, v, scale=0.125).backward(do)
        torch.cuda.synchronize()
        moved = [c.launches - b for c, b in zip(counters, before)]
        assert moved == ([0, 1, 1, 1] if op is port else [0, 0, 0, 0])
        grads.append((q.grad, k.grad, v.grad))
    for got, ref in zip(*grads):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(
            got.float(), ref.float(), rtol=0,
            atol=ATTN_BF16_TOL * max(1.0, ref.float().abs().max().item()))
    with torch.no_grad():
        before = bst_attn.attention_fwd.launches
        port.attention(q0, k0, v0, scale=0.125)
        assert bst_attn.attention_fwd.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("ctx,bs,hs,kind", [
    (40, 8, 16, "fixed"), (64, 8, 32, "fixed"), (64, 16, 8, "fixed"),
    (64, 16, 48, "fixed"), (64, 32, 96, "fixed"), (40, 8, 48, "f1")])
def test_attention_every_fused_size_runs_the_kernels(cuda, ctx, bs, hs, kind,
                                                      dtype):
    """Block size 8 (the kernels' bs-16 view; ctx 40 pads one hidden
    8-row) and head sizes 8, 48 and 96 (zero-padded to 16, 64 and 128):
    the serving forward, the training forward's out and lse, dq, dk and dv
    run the kernels (each counter moves) and match the plain versions at
    the op's own sizes; two runs equal bit for bit.  "f1": a causal
    layout whose query row 11 sees no key: zero out and dq, lse -inf."""
    heads, blks = 2, ctx // bs
    if kind == "f1":
        port = BlocksparseTransformer(np.tril(np.ones((blks, blks),
                                                      np.int32)),
                                      block_size=bs, heads=heads,
                                      mask_callback=_f1_mask)
    else:
        port = BlocksparseTransformer(fixed_layout(blks, local_blocks=2),
                                      block_size=bs, heads=heads,
                                      mask_callback=causal_subblock_mask)
    g = torch.Generator(device=cuda).manual_seed(ctx + bs + hs)
    qkv = torch.randn((2, ctx, 3 * heads * hs), device=cuda,
                      generator=g).to(dtype)
    q, k, v = qkv.split(heads * hs, dim=-1)
    do = torch.randn((2, ctx, heads * hs), device=cuda, generator=g).to(dtype)
    scale = 1.0 / np.sqrt(hs)
    tab = port._tables(cuda)
    counters = (bst_attn.attention_fwd, bst_attn.attention_fwd_lse,
                bst_attn.attention_dq, bst_attn.attention_dkv)

    def run(op):
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        out = op.attention(qr, kr, vr, scale=scale)
        out.backward(do)
        with torch.no_grad():
            serve = op.attention(q, k, v, scale=scale)
        if op is port:
            lse = port._kernel_fwd(q, k, v, scale, with_lse=True)[1]
        else:
            lse = bst_attn.attention_fwd_lse_plain(
                q, k, v, tab["q_blk"], tab["k_blk"], tab["mask"], heads, bs,
                scale)[1]
        return [serve, out.detach(), lse, qr.grad, kr.grad, vr.grad]

    before = [c.launches for c in counters]
    got = run(port)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 2, 1, 1]
    again = run(port)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    before = [c.launches for c in counters]
    ref = run(_plain_twin(port))
    assert [c.launches for c in counters] == before
    tol = F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    for name, a, r in zip(("serve", "out", "lse", "dq", "dk", "dv"), got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        if name == "lse":
            live = torch.isfinite(r)
            assert torch.equal(live, torch.isfinite(a))
            assert (a[live] - r[live]).abs().max().item() <= 1e-4, name
            continue
        r = r.float()
        torch.testing.assert_close(a.float(), r, rtol=0, atol=tol * max(
            1.0, r.abs().max().item()), msg=name)
    if kind == "f1":
        dead = 1 * bs + 3
        out, lse, dq = got[1], got[2], got[3]
        assert (out[:, dead] == 0).all() and (dq[:, dead] == 0).all()
        assert torch.isneginf(lse[:, :, dead]).all()
        assert all(bool(torch.isfinite(t).all()) for t in got[3:])


@pytest.mark.cuda
def test_attention_head_size_past_128_raises_on_the_card(cuda):
    """hs > 128: the fused route (use_fused=True) raises on the card, where
    its kernels stop, rather than run the plain versions; by default the
    op runs the unfused ops on their kernels, as the reference does."""
    port = BlocksparseTransformer(fixed_layout(2, local_blocks=2),
                                  block_size=16, heads=1,
                                  mask_callback=causal_subblock_mask)
    q = torch.randn((1, 32, 136), device=cuda)
    before = bst_attn.attention_fwd.launches
    with pytest.raises(NotImplementedError, match="unfused"):
        port.attention(q, q, q, use_fused=True)
    assert bst_attn.attention_fwd.launches == before
    trio = _trio_counts()
    y = port.attention(q, q, q)
    assert _trio_counts() == (trio[0] + 1, trio[1] + 1, trio[2])
    torch.testing.assert_close(y, _plain_twin(port).attention(q, q, q),
                               rtol=0, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [True, False])
def test_train_step_kernels_match_plain_model(cuda, recompute):
    """One f32 train step of the tiny model on the kernels against the same
    step on the plain versions, and the launch count of every kernel."""
    cfg = TransformerConfig(
        n_vocab=64, n_embd=64, n_layer=2, n_head=4, ctx=64, blk_size=16,
        attn_layout="fixed", local_blocks=2, mlp_ratio=4, mlp_block_size=16,
        mlp_density=0.5, dtype="float32", recompute=recompute)
    models = [SparseTransformerLM(cfg, device=cuda),
              SparseTransformerLM(cfg, device=cuda, impl="xla")]
    sd = params_from_jax(random_jax_params(models[0], seed=5), models[0])
    g = torch.Generator(device=cuda).manual_seed(6)
    tokens, targets = (torch.randint(0, 64, (2, 64), device=cuda,
                                     generator=g) for _ in range(2))
    counters = {"fprop": bsmm_kernels.bsmm_fprop,
                "bprop": bsmm_kernels.bsmm_bprop,
                "updat": bsmm_kernels.bsmm_updat,
                "fwd": bst_attn.attention_fwd,
                "fwd_lse": bst_attn.attention_fwd_lse,
                "dq": bst_attn.attention_dq, "dkv": bst_attn.attention_dkv}
    L, r = cfg.n_layer, 2 if recompute else 1
    # the step is a CUDA graph: its first call runs one eager step (the
    # warm-up) and captures one, so each kernel launches twice a step's
    want = {"fprop": 4 * r * L, "bprop": 4 * L, "updat": 4 * L, "fwd": 0,
            "fwd_lse": 2 * r * L, "dq": 2 * L, "dkv": 2 * L}
    out = []
    for m in models:
        m.load_state_dict(sd)
        opt = AdamOptimizer(learning_rate=1e-3)
        before = {n: c.launches for n, c in counters.items()}
        state, metrics, scale = m.make_train_step(opt)(
            opt.init(dict(m.named_parameters())), tokens, targets, 1024.0)
        torch.cuda.synchronize()
        moved = {n: c.launches - before[n] for n, c in counters.items()}
        assert moved == (want if m.impl is None else dict.fromkeys(want, 0))
        out.append((metrics, state, m.state_dict()))
    (m0, s0, p0), (m1, s1, p1) = out
    for k in m0:
        torch.testing.assert_close(m0[k], m1[k], rtol=1e-4, atol=0)
    for k in s0["mean"]:
        ref = s1["mean"][k]
        torch.testing.assert_close(s0["mean"][k], ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())
        live = ref.abs() > 1e-2 * ref.abs().max()
        assert (p0[k] - p1[k]).abs()[live].max() <= 1e-5


# ---------------- the block-sparse conv: im2col, col2im and the path ----

# (N, C, bC, H, W, R, S, pt, pl): N = 1, C = bC, N·H·W not a multiple of
# 32, H = 1, pads 0 and R - 1, asymmetric filters, every block size
_IM2COL_CASES = [(1, 8, 8, 5, 5, 3, 3, 1, 1), (3, 32, 16, 1, 37, 1, 3, 0, 2),
                 (2, 64, 32, 7, 9, 3, 3, 2, 0), (2, 128, 64, 6, 5, 3, 1, 0, 0),
                 (1, 256, 128, 4, 6, 5, 5, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("case", _IM2COL_CASES,
                         ids=[f"N{c[0]}-C{c[1]}-b{c[2]}-{c[3]}x{c[4]}-"
                              f"{c[5]}x{c[6]}-p{c[7]}{c[8]}"
                              for c in _IM2COL_CASES])
def test_im2col_col2im_kernels_match_plain(cuda, case, dtype):
    """im2col equals its plain version exactly; col2im exactly in f32 and
    within one output rounding in bf16/f16.  X comes back as the transposed
    view of an NC array, and col2im reads such a view in place."""
    N, C, bC, H, W, R, S, pt, pl = case
    args = (H, W, R, S, pt, pl, bC)
    g = torch.Generator(device=cuda).manual_seed(7)
    xc = torch.randn((C, N * H * W), device=cuda, generator=g).to(dtype)
    before = (im2col_kernels.im2col.launches, im2col_kernels.col2im.launches)
    X = im2col_kernels.im2col(xc, *args)
    dx = im2col_kernels.col2im(X, *args)
    torch.cuda.synchronize()
    assert (im2col_kernels.im2col.launches,
            im2col_kernels.col2im.launches) == (before[0] + 1, before[1] + 1)
    assert X.shape == (C * R * S, N * H * W) and X.t().is_contiguous()
    assert torch.equal(X, im2col_kernels.im2col_plain(xc, *args))
    ref = im2col_kernels.col2im_plain(X, *args)
    eps = 0.0 if dtype == torch.float32 else torch.finfo(dtype).eps
    torch.testing.assert_close(
        dx.float(), ref.float(), rtol=0,
        atol=eps * max(1.0, ref.float().abs().max().item()))
    dX = torch.randn((C * R * S, N * H * W), device=cuda, generator=g).to(dtype)
    ref = im2col_kernels.col2im_plain(dX, *args)
    torch.testing.assert_close(
        im2col_kernels.col2im(dX, *args).float(), ref.float(), rtol=0,
        atol=eps * max(1.0, ref.float().abs().max().item()))


def _conv_case(device, dtype, stride=1, C=64, b=16, hw=(8, 12), N=3):
    pairs = [(0, 0), (0, 1), (1, 1), (2, 2), (3, 0), (3, 3), (2, 1)]
    BCK = [(tuple(range(cb * b, (cb + 1) * b)),
            tuple(range(kb * b, (kb + 1) * b))) for cb, kb in pairs
           if cb < C // b and kb < C // b]
    kw = dict(strides=(stride, stride), padding="SAME", impl="bsmm")
    port = BlocksparseConv(BCK, (3, 3), hw, **kw)
    plain = BlocksparseConv(BCK, (3, 3), hw, bsmm_impl="xla", **kw)
    F = torch.tensor(random_jax_conv_filter(port, seed=1) * 10,
                     device=device).to(dtype)
    g = torch.Generator(device=device).manual_seed(8)
    x = (torch.rand((N, port.C) + hw, device=device, generator=g) * 2
         - 1).to(dtype)
    return port, plain, F, x


def _conv_fwd_grads(conv, F, x):
    Fr, xr = F.detach().requires_grad_(), x.detach().requires_grad_()
    y = conv(Fr, xr)
    dI, dF = torch.autograd.grad(y.float().square().sum(), (xr, Fr))
    return y, dI, dF


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_kernel_path_matches_plain_path(cuda, dtype, stride):
    """BlocksparseConv(impl="bsmm") on the kernels against bsmm_impl="xla":
    forward, dI and dF of sum(square(y)); one launch of each kernel a
    forward + backward (a strided conv builds X from plain tap slices, so
    it launches no im2col/col2im; a product on the split route is one
    fused bsmm_split launch in bf16, partial tiles counted as fprop or
    bprop in f32)."""
    port, plain, F, x = _conv_case(cuda, dtype, stride)
    counters = {"im2col": im2col_kernels.im2col,
                "col2im": im2col_kernels.col2im,
                "fprop": bsmm_kernels.bsmm_fprop,
                "bprop": bsmm_kernels.bsmm_bprop,
                "split": bsmm_kernels.bsmm_split,
                "updat": bsmm_kernels.bsmm_updat}
    before = {n: c.launches for n, c in counters.items()}
    got = _conv_fwd_grads(port, F, x)
    torch.cuda.synchronize()
    moved = {n: c.launches - before[n] for n, c in counters.items()}
    k = int(stride == 1)
    op, sms = port._bsmm_op, bsmm_kernels.device_sm_count(cuda)
    rows = x.shape[0] * int(np.prod(port.MPQ))        # the matmul's N
    fused = {d: dtype != torch.float32
             and op._route(rows, d, sms) == "phased" for d in "fb"}
    assert moved == {"im2col": k, "col2im": k, "fprop": 1 - fused["f"],
                     "bprop": 1 - fused["b"],
                     "split": fused["f"] + fused["b"], "updat": 1}
    before = {n: c.launches for n, c in counters.items()}
    refs = _conv_fwd_grads(plain, F, x)
    assert all(c.launches == before[n] for n, c in counters.items())
    tol = F32_TOL if dtype == torch.float32 else BSMM_BF16_TOL
    for a, r in zip(got, refs):
        assert a.dtype == r.dtype == dtype and a.shape == r.shape
        r = r.float()
        torch.testing.assert_close(a.float(), r, rtol=0,
                                   atol=tol * max(1.0, r.abs().max().item()))
    with torch.no_grad():
        before = {n: c.launches for n, c in counters.items()}
        port(F, x)
        moved = {n: c.launches - before[n] for n, c in counters.items()}
        assert moved == {"im2col": k, "col2im": 0, "fprop": 1 - fused["f"],
                         "bprop": 0, "split": int(fused["f"]), "updat": 0}


@pytest.mark.cuda
def test_im2col_raises_and_never_falls_back(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: a failed build or a
    refused launch raises, and the plain version does not step in."""
    from blocksparse_tpu_torch.kernels import _build
    xc = torch.randn((16, 2 * 6 * 6), device=cuda)
    args = (6, 6, 3, 3, 1, 1, 8)
    with pytest.raises(ValueError):
        im2col_kernels.im2col(xc, 6, 6, 3, 3, 1, 1, 12)   # bC not 8-128
    with pytest.raises(ValueError):
        im2col_kernels._im2col_cuda(xc.cpu(), 16, 2, 6, 6, 72, 36, *args[2:])
    before = (im2col_kernels.im2col.launches, im2col_kernels.col2im.launches)

    def no_build(*a, **k):
        raise RuntimeError("nvcc failed for im2col.cu")
    monkeypatch.setattr(_build, "function", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        im2col_kernels.im2col(xc, *args)
    monkeypatch.setattr(_build, "function", lambda *a, **k: lambda *b: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        im2col_kernels.col2im(torch.randn((144, 72), device=cuda), *args)
    assert (im2col_kernels.im2col.launches,
            im2col_kernels.col2im.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bC", [8, 16, 32, 64, 128])
def test_im2col_image_kernel_matches_plain(cuda, bC, dtype):
    """im2col.cu reading the image in place, at every channel block and
    dtype, on NCHW images of 32 x 32, 7 x 9 (W off a 16-byte run), 5 x 16
    and 3 x 300, 3x3 filters at pads (0, 0) and (1, 1) and a 1x3 one:
    equal to im2col_plain of the channel-major copy bit for bit, and so is
    X from the channel-major array seen as an image (channel stride
    N·H·W), read in place too; two runs bit-equal, one launch a call.  The
    backward, col2im_image, writes the NCHW gradient, equal to
    col2im_plain's bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(bC + 1)
    C = 2 * bC
    for N, H, W in ((2, 32, 32), (2, 7, 9), (3, 5, 16), (1, 3, 300)):
        for R, S, pt, pl in ((3, 3, 0, 0), (3, 3, 1, 1), (1, 3, 0, 2)):
            args = (R, S, pt, pl, bC)
            x = torch.randn((N, C, H, W), device=cuda, generator=g).to(dtype)
            xc = x.transpose(0, 1).reshape(C, N * H * W)
            want = im2col_kernels.im2col_plain(xc, H, W, *args)
            before = im2col_kernels.im2col.launches
            X, again = (im2col_kernels.im2col_image(x, *args)
                        for _ in range(2))
            Xv = im2col_kernels.im2col_image(
                xc.reshape(C, N, H, W).transpose(0, 1), *args)
            torch.cuda.synchronize()
            assert im2col_kernels.im2col.launches == before + 3
            assert X.shape == want.shape and X.t().is_contiguous()
            assert torch.equal(X, want) and torch.equal(again, X)
            assert torch.equal(Xv, want), (N, H, W, R, S, pt, pl)
            dX = torch.randn((N * H * W, C * R * S), device=cuda,
                             generator=g).to(dtype).t()
            before = im2col_kernels.col2im.launches
            dI = im2col_kernels.col2im_image(dX, N, H, W, *args)
            torch.cuda.synchronize()
            assert im2col_kernels.col2im.launches == before + 1
            ref = im2col_kernels.col2im_plain(dX, H, W, *args).reshape(
                C, N, H, W).transpose(0, 1)
            assert dI.shape == (N, C, H, W) and dI.is_contiguous()
            assert torch.equal(dI, ref), (N, H, W, R, S, pt, pl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bC", [8, 16, 32, 64, 128])
def test_col2im_tma_kernel_matches_plain(cuda, bC, dtype):
    """col2im_tma.cu at every channel block and dtype, on images of 7 x 9
    (W not a multiple of a 16-byte run), 32 x 32 and 3 x 300 (W past TMA's
    256-pixel box), 3x3 filters at pads (0, 0), (1, 1) and (2, 2) and a
    1x3 one: equal to col2im_plain bit for bit in f32, within one rounding
    in bf16/f16; two runs bit-equal; one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(bC)
    eps = 0.0 if dtype == torch.float32 else torch.finfo(dtype).eps
    C = 2 * bC
    for N, H, W in ((2, 7, 9), (2, 32, 32), (1, 3, 300)):
        for R, S, pt, pl in ((3, 3, 0, 0), (3, 3, 1, 1), (3, 3, 2, 2),
                             (1, 3, 0, 2)):
            args = (H, W, R, S, pt, pl, bC)
            dX = torch.randn((N * H * W, C * R * S), device=cuda,
                             generator=g).to(dtype).t()
            before = im2col_kernels.col2im.launches
            dx, again = (im2col_kernels.col2im(dX, *args) for _ in range(2))
            torch.cuda.synchronize()
            assert im2col_kernels.col2im.launches == before + 2
            assert torch.equal(dx, again)
            ref = im2col_kernels.col2im_plain(dX, *args)
            assert dx.dtype == dtype and dx.shape == ref.shape
            torch.testing.assert_close(
                dx.float(), ref.float(), rtol=0,
                atol=eps * max(1.0, ref.float().abs().max().item()))
            if dtype == torch.float32:
                assert torch.equal(dx, ref), (N, H, W, R, S, pt, pl)


@pytest.mark.cuda
def test_col2im_repeated_calls_bit_equal(cuda):
    """col2im_tma.cu refills a ring slot by TMA only after every thread's
    reads of it are ordered before the refill (fence.proxy.async): without
    that fence, repeated calls at the conv bench's shape (C 512, N 32, 32
    x 32, b32), bf16 and f32 in turns on fresh dX, now and then summed a
    box that the next TMA load was overwriting.  Every call here equals
    col2im_plain bit for bit, into (C, N·H·W) and into NCHW."""
    C, N, H, W, bC = 512, 32, 32, 32, 32
    args = (H, W, 3, 3, 1, 1, bC)
    g = torch.Generator(device=cuda).manual_seed(11)
    for _ in range(4):
        for dtype in (torch.bfloat16, torch.float32):
            dX = torch.randn((N * H * W, C * 9), device=cuda,
                             generator=g).to(dtype).t()
            ref = im2col_kernels.col2im_plain(dX, *args)
            ref_i = ref.reshape(C, N, H, W).transpose(0, 1)
            for _ in range(4):
                assert torch.equal(im2col_kernels.col2im(dX, *args), ref)
                assert torch.equal(
                    im2col_kernels.col2im_image(dX, N, *args), ref_i)
            del dX, ref, ref_i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_col2im_refuses_an_unaligned_view(cuda, dtype):
    """TMA reads a 16-byte aligned tensor: an NC array that starts off a
    16-byte boundary raises, with no launch and no plain fallback."""
    H, W, bC = 6, 8, 8
    NP, CT = 2 * H * W, 16 * 9
    flat = torch.randn(NP * CT + 1, device=cuda).to(dtype)
    dX = flat[1:].view(NP, CT).t()
    assert dX.t().is_contiguous() and dX.t().data_ptr() % 16
    before = im2col_kernels.col2im.launches
    with pytest.raises(ValueError, match="16-byte"):
        im2col_kernels.col2im(dX, H, W, 3, 3, 1, 1, bC)
    assert im2col_kernels.col2im.launches == before


# ---------------- the schedule modes: fine, window, split + merge ----------

def _mode_ops(layout, bsize, **kw):
    return {m: BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                                 mode=m, **kw)
            for m in ("fine", "window", "grouped", "auto")}


def _counts():
    return {n: getattr(bsmm_kernels, n).launches for n in (
        "bsmm_fprop", "bsmm_bprop", "bsmm_fine", "bsmm_window", "bsmm_merge",
        "bsmm_split")}


def _moved(before):
    return {n: c - before[n] for n, c in _counts().items() if c != before[n]}


@contextlib.contextmanager
def _mode_kernel(kernel):
    """The fine and window modes' bf16/f16 kernel pinned to ``kernel``
    ("wgmma" or "mma"; None: the rules fine_kernel/window_kernel)."""
    rules = bsmm_kernels.fine_kernel, bsmm_kernels.window_kernel
    if kernel is not None:
        bsmm_kernels.fine_kernel = bsmm_kernels.window_kernel = \
            lambda *_: kernel
    try:
        yield
    finally:
        bsmm_kernels.fine_kernel, bsmm_kernels.window_kernel = rules


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_fine_and_window_kernels_match_plain_and_unsplit(cuda, bsize, dtype,
                                                         monkeypatch):
    """fprop and bprop of mode="fine" (b8-b32) and mode="window" against
    the plain version, two runs equal bit for bit, and in f32 bit for bit
    against the unsplit kernel (in bf16 and f16 that kernel sums on the
    tensor cores, in another order, and is itself held against the plain
    version).  bf16 and f16 run the source the rules fine_kernel and
    window_kernel pick, then each tensor-core source pinned in turn: the
    wgmma ones (bsmm_fine_wgmma.cu; bsmm_window_wgmma.cu, whose packing
    of the weights builds from the same source) and the mma.sync ones
    (bsmm_fine_mma.cu, bsmm_window_mma.cu); f32 the CUDA-core ones.  Two
    layouts: a sparse one with an empty output column, an empty input row
    and a window count that does not divide C; a dense one whose windows
    hold more entries than one W stage of the mma.sync window kernel.  N
    of 1, 63, 64, 65, 300 and 4224, where window_tn's N-tile changes (the
    wgmma window kernel's N-tile 128 runs in chip_smoke.py's block-size
    checks)."""
    from blocksparse_tpu_torch.kernels import _build
    used = []
    build_fn = _build.function

    def spy(name, fn_name, argtypes):
        used.append(name)
        return build_fn(name, fn_name, argtypes)
    monkeypatch.setattr(_build, "function", spy)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    CB = 2 * 256 // bsize + 3                # 2 windows and a partial one
    sparse = random_layout(CB, 6, 0.4, seed=bsize + 3)
    sparse[:, 2] = 0
    sparse[1, :] = 0
    dense = np.ones((256 // bsize, 24), np.int32)
    modes = ("fine", "window") if bsize <= 32 else ("window",)
    pins = (None,) if dtype == torch.float32 else (None, "wgmma", "mma")
    g = torch.Generator(device=cuda).manual_seed(bsize)
    tiles = set()
    for layout in (sparse, dense):
        ops = _mode_ops(layout, bsize)
        plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                                  impl="xla")
        w = torch.randn(plain.w_shape, device=cuda, generator=g).to(dtype)
        for N in (1, 63, 64, 65, 300, 4224):
            for d, width, n_out in (("f", plain.C, plain.KB),
                                    ("b", plain.K, plain.CB)):
                x = torch.randn((N, width), device=cuda, generator=g).to(dtype)
                ref = plain._xprop(x, w, d).float()
                atol = _tol(dtype, BSMM_BF16_TOL, ref.abs().max().item())
                unsplit = ops["grouped"]._xprop(x, w, d)
                torch.testing.assert_close(unsplit.float(), ref, rtol=0,
                                           atol=atol)
                tiles.add(bsmm_kernels.window_tn(
                    N, -(-n_out // bsmm_kernels.WINDOW_SG[bsize]), sms))
                for m in modes:
                    for pin in pins:
                        with _mode_kernel(pin):
                            src = ops[m].kernel_of(N, d, dtype, sms)
                            before = _counts()
                            wg = getattr(bsmm_kernels, f"bsmm_{m}") \
                                .launches_wgmma
                            used.clear()
                            y, again = (ops[m]._xprop(x, w, d),
                                        ops[m]._xprop(x, w, d))
                        torch.cuda.synchronize()
                        on = src.endswith("_wgmma")
                        if pin is not None:
                            assert src == f"bsmm_{m}_{pin}"
                        elif dtype == torch.float32:
                            assert src == f"bsmm_{m}"
                        assert _moved(before) == {f"bsmm_{m}": 2}
                        assert getattr(bsmm_kernels, f"bsmm_{m}") \
                            .launches_wgmma - wg == 2 * on
                        # the window's wgmma route: its packing, then the
                        # kernel, both in bsmm_window_wgmma.cu
                        assert used == [src] * (4 if on and m == "window"
                                                else 2), (m, pin, used)
                        assert torch.equal(y, again), (m, pin, d, N)
                        if dtype == torch.float32:
                            assert torch.equal(y, unsplit), (m, d, N)
                        torch.testing.assert_close(y.float(), ref, rtol=0,
                                                   atol=atol)
                        if layout is sparse:
                            empty = slice(2 * bsize, 3 * bsize) \
                                if d == "f" else slice(bsize, 2 * bsize)
                            assert (y[:, empty] == 0).all()
    assert len(tiles) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", ["f", "b"])
def test_window_wgmma_spreads_a_non_finite_input(cuda, d):
    """An infinity in x at one input block (bf16): the plain version and
    bsmm_window_mma.cu make its row non-finite in the output columns with
    an entry at that block; bsmm_window_wgmma.cu also, as NaN, in the
    columns that share a present cell with one of those and have none
    there (the cell's zero block times the infinity: it never hides a
    non-finite input, it spreads it); every other output equal bit for
    bit to the call without the infinity."""
    from test_torch_bsmm_mode_wgmma_plan import window_non_finite_block
    layout = random_layout(40, 24, 0.3, seed=21 + (d == "b"))
    op = BlocksparseMatMul(layout, block_size=16, feature_axis=1,
                           mode="window")
    plain = BlocksparseMatMul(layout, block_size=16, feature_axis=1,
                              impl="xla")
    i, reads, partners = window_non_finite_block(op, d)
    g = torch.Generator(device=cuda).manual_seed(21)
    w = (torch.randn(op.w_shape, device=cuda, generator=g) * 0.2).bfloat16()
    x = torch.randn((300, op.C if d == "f" else op.K), device=cuda,
                    generator=g).bfloat16()
    with _mode_kernel("wgmma"):
        clean = op._xprop(x, w, d)
        x[3, i * 16 + 5] = float("inf")
        y = op._xprop(x, w, d)
    with _mode_kernel("mma"):
        y_mma = op._xprop(x, w, d)

    def bad(t):
        nf = ~torch.isfinite(t[3].float().reshape(-1, 16))
        assert torch.equal(nf.any(1), nf.all(1))
        return set(torch.nonzero(nf.all(1)).flatten().tolist())
    assert bad(plain._xprop(x, w, d)) == reads
    assert bad(y_mma) == reads
    assert bad(y) == reads | partners
    assert torch.isnan(y[3].reshape(-1, 16)[sorted(partners)]).all()
    keep = torch.ones_like(y, dtype=torch.bool)
    for c in reads | partners:
        keep[3, c * 16:(c + 1) * 16] = False
    assert torch.equal(y[keep], clean[keep])


@pytest.mark.cuda
def test_mode_wgmma_kernel_info_shows_no_local_memory(cuda):
    """The wgmma mode kernels' instantiations spill nothing and fit on an
    SM (the window kernel one block an SM, the fine kernel two)."""
    for dtype in HALF:
        for b in (16, 32, 64):
            i = bsmm_kernels.mode_kernel_info("bsmm_window_wgmma", dtype, b)
            assert i["local_bytes"] == 0 and i["blocks_per_sm"] == 1
        for b in bsmm_kernels.FINE_BLOCK_SIZES:
            for trans in (False, True):
                i = bsmm_kernels.mode_kernel_info("bsmm_fine_wgmma", dtype, b,
                                                  trans_w=trans)
                assert i["local_bytes"] == 0 and i["blocks_per_sm"] == 2


@pytest.mark.cuda
def test_mode_sources_refuse_other_dtypes(cuda):
    """The tensor-core fine and window sources refuse f32 (dtype 0), the
    CUDA-core ones bf16 and f16 (dtypes 1 and 2), bsmm_fine_wgmma.cu f32
    and an unknown dtype 3: cudaErrorInvalidValue."""
    from blocksparse_tpu_torch.kernels import _build
    layout = random_layout(4, 4, 1.0, seed=0)
    op = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    x = torch.randn((4, op.C), device=cuda)
    w = torch.randn(op.w_shape, device=cuda)
    y = torch.empty((4, op.K), device=cuda)
    fine = op._plan_tensors(cuda, "fine", "f")
    win = op._plan_tensors(cuda, "window", "f")
    args = {"bsmm_fine": (fine["chunk_ptr"], fine["slot_in"], fine["slot_w"]),
            "bsmm_window": (win["ptr"], win["ent_slot"], win["ent_w"])}
    for name, ints in args.items():
        ptrs = [t.data_ptr() for t in ints]
        for source, dtypes in ((name, (1, 2)), (name + "_mma", (0,)),
                               *(((name + "_wgmma", (0, 3)),)
                                 if name == "bsmm_fine" else ())):
            extra = [16] if source == "bsmm_window_mma" else []
            fn = _build.function(
                source, source + "_nc",
                bsmm_kernels._XPROP_ARGS[:-1]
                + [bsmm_kernels._I] * len(extra) + [bsmm_kernels._P])
            for code in dtypes:
                assert fn(code, 16, 0, x.data_ptr(), w.data_ptr(), *ptrs,
                          y.data_ptr(), 4, op.C, op.K, *extra,
                          bsmm_kernels._stream(x)) == 1, (source, code)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_merge_kernel_matches_plain(cuda, bsize, dtype):
    """Random f32 tiles merged through a split plan's index (columns of 0,
    1 and up to 8 runs; the sentinel tile zero): exact against
    merge_plain in every output dtype."""
    layout = random_layout(40, 9, 0.5, seed=bsize)
    layout[:, 3] = 0
    op = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)
    plan = op._plan("split", "f", 8)
    g = torch.Generator(device=cuda).manual_seed(9)
    for N in (1, 7, 130):
        tiles = torch.randn((N, plan["tiles"] * bsize), device=cuda,
                            generator=g)
        tiles[:, -bsize:] = 0
        idx = torch.as_tensor(plan["merge_idx"], device=cuda)
        before = bsmm_kernels.bsmm_merge.launches
        y = bsmm_kernels.bsmm_merge(tiles, idx, bsize, dtype)
        torch.cuda.synchronize()
        assert bsmm_kernels.bsmm_merge.launches == before + 1
        ref = bsmm_kernels.merge_plain(tiles, idx.long(), bsize, dtype)
        assert y.dtype == dtype and torch.equal(y, ref)
        assert (y[:, 3 * bsize:4 * bsize] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("bsize", [8, 32, 128])
def test_split_route_matches_plain(cuda, bsize, dtype):
    """Below the SM count auto runs the split route: in f32 partial tiles
    (counted as bsmm_fprop / bsmm_bprop, whose kernel it is) and one merge,
    in bf16/f16 one fused bsmm_split launch; grouped runs unsplit.  Both
    against the plain version, the split route against the plain split
    route in f32."""
    layout = random_layout(48, 5, 0.5, seed=bsize + 1)
    layout[:, 2] = 0
    ops = _mode_ops(layout, bsize)
    plain = BlocksparseMatMul(layout, block_size=bsize, feature_axis=1,
                              impl="xla")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn(plain.w_shape, device=cuda, generator=g).to(dtype)
    for N, d in ((3, "f"), (70, "f"), (5, "b")):
        width = plain.C if d == "f" else plain.K
        x = torch.randn((N, width), device=cuda, generator=g).to(dtype)
        direct = "bsmm_fprop" if d == "f" else "bsmm_bprop"
        split = ops["auto"]._phases(N, d, sms) > 0
        assert split == (d == "f")           # the bprop columns are short
        before = _counts()
        y = ops["auto"]._xprop(x, w, d)
        torch.cuda.synchronize()
        fused = {"bsmm_split": 1} if dtype != torch.float32 else \
            {direct: 1, "bsmm_merge": 1}
        assert _moved(before) == (fused if split else {direct: 1})
        before = _counts()
        y_unsplit = ops["grouped"]._xprop(x, w, d)
        assert _moved(before) == {direct: 1}
        ref = plain._xprop(x, w, d).float()
        for got in (y, y_unsplit):
            torch.testing.assert_close(
                got.float(), ref, rtol=0,
                atol=_tol(dtype, BSMM_BF16_TOL, ref.abs().max().item()))
        if split and dtype == torch.float32:
            torch.testing.assert_close(
                y, plain.xprop_split_plain(x, w, d, sms), rtol=0,
                atol=F32_TOL * max(1.0, ref.abs().max().item()))


def _split_layout(bsize, seed):
    """A square layout whose output column 0 and input row 0 are full (40
    entries: 8 runs of the split in fprop and bprop), with output column
    2 and input row 2 empty."""
    layout = random_layout(40, 40, 0.6, seed=seed)
    layout[:, 0] = 1
    layout[0, :] = 1
    layout[:, 2] = 0
    layout[2, :] = 0
    return BlocksparseMatMul(layout, block_size=bsize, feature_axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("bsize", [8, 16, 32, 64, 128])
def test_split_kernel_equals_partials_and_merge(cuda, bsize, dtype):
    """bsmm_split, one launch of clusters of P blocks, equals bsmm_merge
    over bsmm_partials bit for bit, fprop and bprop, P 2 to 8, N 1, 5 and
    300, an empty column zero; two runs bit-equal; within the matmul's
    tolerance of the plain version."""
    op = _split_layout(bsize, seed=bsize)
    plain = BlocksparseMatMul(op.layout.astype(np.int32), block_size=bsize,
                              feature_axis=1, impl="xla")
    lut = op._lut(cuda)
    g = torch.Generator(device=cuda).manual_seed(bsize + 1)
    w = torch.randn(op.w_shape, device=cuda, generator=g).to(dtype)
    for d in "fb":
        ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
        for P in (2, 3, 5, 8):
            p = op._plan_tensors(cuda, "split", d, P)
            assert p["merge_idx"].shape[1] == P
            n_tiles = p["tile_ptr"].numel() - 1
            n_out, width = (op.KB, op.C) if d == "f" else (op.CB, op.K)
            for N in (1, 5, 300):
                x = torch.randn((N, width), device=cuda,
                                generator=g).to(dtype)

                def fused():
                    return bsmm_kernels.bsmm_split(
                        x, w, p["tile_ptr"], *ents, p["merge_idx"], bsize,
                        n_out, d == "b")
                before = _counts()
                y, again = fused(), fused()
                torch.cuda.synchronize()
                assert _moved(before) == {"bsmm_split": 2}
                assert y.dtype == dtype and y.shape == (N, n_out * bsize)
                assert torch.equal(y, again)
                parts = bsmm_kernels.bsmm_partials(x, w, p["tile_ptr"], *ents,
                                                   bsize, n_tiles, d == "b")
                ref = bsmm_kernels.bsmm_merge(parts, p["merge_idx"], bsize,
                                              dtype)
                assert torch.equal(y, ref), (d, P, N)
                assert (y[:, 2 * bsize:3 * bsize] == 0).all()
                want = plain._xprop(x, w, d).float()
                torch.testing.assert_close(
                    y.float(), want, rtol=0,
                    atol=_tol(dtype, BSMM_BF16_TOL, want.abs().max().item()))


@pytest.mark.cuda
def test_split_kernel_raises_and_never_falls_back(cuda, monkeypatch):
    """bsmm_split refuses a CPU tensor and f32, and a refused launch
    raises: no launch is counted and no plain version steps in."""
    from blocksparse_tpu_torch.kernels import _build
    op = _split_layout(16, seed=0)
    p = op._plan_tensors(cuda, "split", "f", 8)
    lut = op._lut(cuda)
    w = torch.randn(op.w_shape, device=cuda).bfloat16()
    x = torch.randn((3, op.C), device=cuda).bfloat16()
    args = (p["tile_ptr"], lut["f_ent_in"], lut["f_ent_w"], p["merge_idx"],
            16, op.KB)
    before = bsmm_kernels.bsmm_split.launches
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_split(x.cpu(), w.cpu(), *args)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_split(x.float(), w.float(), *args)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_split(x, w, args[0], args[1].long(), *args[2:])
    monkeypatch.setattr(_build, "function", lambda *a, **k: lambda *b: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        bsmm_kernels.bsmm_split(x, w, *args)
    assert bsmm_kernels.bsmm_split.launches == before


@pytest.mark.cuda
def test_modes_route_fprop_bprop_and_dispatch_mode(cuda):
    """Autograd through each mode: the launches name the route that
    dispatch_mode gives, updat runs in every mode, and the gradients
    match the plain op."""
    layout = random_layout(24, 12, 0.5, seed=2)
    ops = _mode_ops(layout, 16)
    plain = BlocksparseMatMul(layout, block_size=16, feature_axis=1,
                              impl="xla")
    g = torch.Generator(device=cuda).manual_seed(5)
    N = 6
    x0 = torch.randn((N, plain.C), device=cuda, generator=g)
    w0 = torch.randn(plain.w_shape, device=cuda, generator=g)
    dy = torch.randn((N, plain.K), device=cuda, generator=g)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split_b = int(ops["auto"]._phases(N, "b", sms) > 0)
    want = {"fine": {"bsmm_fine": 2}, "window": {"bsmm_window": 2},
            "grouped": {"bsmm_fprop": 1, "bsmm_bprop": 1},
            "phased": {"bsmm_fprop": 1, "bsmm_bprop": 1,
                       "bsmm_merge": 1 + split_b}}
    refs = None
    for m, op in ops.items():
        route = op.dispatch_mode(N)
        assert route == (m if m != "auto" else "phased")
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        before = _counts()
        updat = bsmm_kernels.bsmm_updat.launches
        op(x, w).backward(dy)
        torch.cuda.synchronize()
        assert _moved(before) == want[route]
        assert bsmm_kernels.bsmm_updat.launches == updat + 1
        if refs is None:
            xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
            plain(xr, wr).backward(dy)
            refs = (xr.grad, wr.grad)
        for got, ref in zip((x.grad, w.grad), refs):
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
def test_mode_kernels_raise_on_cpu_and_wrong_types(cuda):
    layout = random_layout(4, 4, 1.0, seed=0)
    op = BlocksparseMatMul(layout, block_size=16, feature_axis=1)
    x = torch.randn((4, op.C), device=cuda)
    w = torch.randn(op.w_shape, device=cuda)
    fine = op._plan_tensors(cuda, "fine", "f")
    win = op._plan_tensors(cuda, "window", "f")
    split = op._plan_tensors(cuda, "split", "f", 2)
    lut = op._lut(cuda)
    calls = {
        "fine": lambda a, b: bsmm_kernels.bsmm_fine(
            a, b, fine["chunk_ptr"], fine["slot_in"], fine["slot_w"], 16, 4),
        "window": lambda a, b: bsmm_kernels.bsmm_window(
            a, b, win["ptr"], win["ent_slot"], win["ent_w"], 16, 4),
        "partials": lambda a, b: bsmm_kernels.bsmm_partials(
            a, b, split["tile_ptr"], lut["f_ent_in"], lut["f_ent_w"], 16,
            split["tile_ptr"].numel() - 1, plan=op._xlaunch(cuda, "f", 4, 2))}
    for name, call in calls.items():
        with pytest.raises(ValueError):
            call(x.cpu(), w.cpu())
        with pytest.raises(TypeError):
            call(x.double(), w.double())
        with pytest.raises(TypeError):
            call(x, w.half())
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_fine(x.reshape(2, -1), w.reshape(-1, 32, 32)[:1],
                               fine["chunk_ptr"], fine["slot_in"],
                               fine["slot_w"], 64, 1)
    tiles = torch.zeros((4, 3 * 16), device=cuda)
    idx = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bsmm_kernels.bsmm_merge(tiles.cpu(), idx.cpu(), 16, torch.float32)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_merge(tiles.bfloat16(), idx, 16, torch.float32)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_merge(tiles, idx.long(), 16, torch.float32)
    with pytest.raises(TypeError):
        bsmm_kernels.bsmm_merge(tiles, idx, 16, torch.float64)


# ---------------- the LM's CUDA graphs ----------------

# An LM whose decode MLP products reach the split route (bf16: one fused
# bsmm_split launch a product) at batch 3
GRAPH_LM = dict(n_vocab=64, n_embd=256, n_layer=2, n_head=4, ctx=128,
                blk_size=16, attn_layout="fixed", local_blocks=2,
                mlp_ratio=4, mlp_block_size=16, mlp_density=0.6,
                dtype="bfloat16")


def _graph_lm(device, **kw):
    port = SparseTransformerLM(TransformerConfig(**dict(GRAPH_LM, **kw)),
                               device=device)
    port.load_state_dict(params_from_jax(random_jax_params(port, seed=6),
                                         port))
    return port


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _prompt(device, batch=3, n=20):
    return torch.randint(0, 64, (batch, n), device=device,
                         generator=_gen(device, 2))


def _lm_counts():
    fns = (bsmm_kernels.bsmm_fprop, bsmm_kernels.bsmm_split,
           bsmm_kernels.bsmm_bprop, bsmm_kernels.bsmm_updat,
           bst_attn.attention_fwd, bst_attn.attention_fwd_lse,
           bst_attn.attention_dq, bst_attn.attention_dkv)
    return np.array([f.launches for f in fns])


def _clone_state(s):
    return {k: [{kk: vv.clone() for kk, vv in c.items()} for c in v]
            if k == "caches" else v.clone() for k, v in s.items()}


@pytest.mark.cuda
def test_decode_graph_replay_equals_eager_step(cuda):
    port = _graph_lm(cuda)
    graph = port._decode_graph(3, 1.0)
    s = lm._prompt_state(port, _prompt(cuda), 4, _gen(cuda, 1))
    ref = _clone_state(s)
    for _ in range(2):
        st = graph.run(s, 1)
        lm._token_step(port, ref, 1.0)
        s = _clone_state(ref)
    torch.cuda.synchronize()
    assert int(graph.state["pos"]) == int(ref["pos"]) == 22
    for k in ("tokens", "logits", "pos", "step"):
        assert torch.equal(graph.state[k], ref[k]), k
    assert st is graph.state["tokens"]
    for a, b in zip(graph.state["caches"], ref["caches"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scan_tokens_equal_loop_tokens_on_the_card(cuda, dtype):
    """Same seed, same tokens; the first scan captures (its warm-up and
    its capture each launch the step's kernels once), a later one only
    replays: its wrappers count the prefill's launches and no more."""
    port = _graph_lm(cuda, dtype=dtype)
    prompt = _prompt(cuda)
    loop = generate_cached(port, prompt, 12, 0.9, _gen(cuda, 5))
    scan = generate_cached_scan(port, prompt, 12, 0.9, _gen(cuda, 5))
    assert torch.equal(scan, loop) and len(port._decode_graphs) == 1
    full = torch.zeros((3, 128), dtype=torch.int64, device=cuda)
    full[:, :20] = prompt
    c0 = _lm_counts()
    port.prefill(full)
    c1 = _lm_counts()
    again = generate_cached_scan(port, prompt, 12, 0.9, _gen(cuda, 5))
    c2 = _lm_counts()
    assert torch.equal(again, loop)
    np.testing.assert_array_equal(c2 - c1, c1 - c0)
    assert len(port._decode_graphs) == 1


@pytest.mark.cuda
def test_mode_change_recaptures_the_decode_graph(cuda):
    port = _graph_lm(cuda)
    prompt = _prompt(cuda)
    routes = port._mlp_routes(3)
    generate_cached_scan(port, prompt, 6, generator=_gen(cuda, 8))
    for op in (port.bsmm1, port.bsmm2):
        op.mode = "grouped"
    split = bsmm_kernels.bsmm_split.launches
    grouped = generate_cached_scan(port, prompt, 6, generator=_gen(cuda, 8))
    assert len(port._decode_graphs) == 2
    assert port._mlp_routes(3) != routes
    assert bsmm_kernels.bsmm_split.launches == split    # no split route
    assert torch.equal(grouped, generate_cached(port, prompt, 6,
                                                generator=_gen(cuda, 8)))


# The plain-version model's step against itself, captured and eager: its
# products sum through index_add_'s atomics, in no fixed order, so the
# two differ by f32 rounding, and where a gradient is rounding noise its
# sign, hence Adam's move of the element, may flip: chip_smoke.py's
# tolerances for the plain model, STEP_LOSS_TOL relative on loss, grad
# norm and scale, GRAD_TOL of each slot's max on Adam's slots, and on a
# parameter Adam's largest two moves (lr at t = 1, 1.41 lr at t = 2:
# 0.19 / sqrt(0.001) times lr·sqrt(1 - 0.999^2) / (1 - 0.9^2)) from each
# side: 5 lr.
STEP_LOSS_TOL, GRAD_TOL = 1e-2, 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("impl", [None, "xla"])
def test_captured_train_step_equals_eager_step(cuda, impl):
    """Two steps of the captured step (loss scale first as a float, then
    the returned tensor; the returned state passed back in place) against
    two eager steps of the same model from the same weights: on the
    kernels, metrics, scale, state and parameters equal bit for bit (the
    first call's warm-up leaves no trace); on the plain versions within
    the tolerances above."""
    kw = dict(GRAPH_LM, recompute=True)
    models = []
    for _ in range(2):
        m = SparseTransformerLM(TransformerConfig(**kw), device=cuda,
                                impl=impl)
        m.load_state_dict(params_from_jax(random_jax_params(m, seed=7), m))
        models.append(m)
    seq = torch.randint(0, 64, (2, 129), device=cuda,
                        generator=_gen(cuda, 3))
    tokens, targets = seq[:, :-1], seq[:, 1:]
    lr = 1e-3
    adam = AdamOptimizer(learning_rate=lr, zero_nans=True, zero_infs=True)
    runs = []
    for m, graph in zip(models, (True, False)):
        step = m.make_train_step(adam)
        fn = step if graph else step._eager
        state, scale, metrics = adam.init(dict(m.named_parameters())), \
            1024.0, []
        for _ in range(2):
            state, mt, scale = fn(state, tokens, targets, scale)
            metrics.append(mt)
        torch.cuda.synchronize()
        runs.append((state, metrics, scale, m.state_dict()))
        if graph:
            assert len(step._graphs) == 1 and len(step.captures) == 1
            (g,) = step._graphs.values()
            assert state is g["state"]
    (s0, m0, sc0, p0), (s1, m1, sc1, p1) = runs
    assert int(s0["t"]) == int(s1["t"]) == 2 and float(sc0) > 1024.0
    if impl is None:
        for a, b in zip(m0, m1):
            for k in ("loss", "grad_norm", "norm_scale"):
                assert torch.equal(a[k], b[k]), k
        assert torch.equal(sc0, sc1)
        assert all(torch.equal(p0[k], p1[k]) for k in p0)
        for slot in ("mean", "var"):
            assert all(torch.equal(s0[slot][k], s1[slot][k])
                       for k in s1[slot])
        return
    close = dict(rtol=STEP_LOSS_TOL, atol=0)
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "norm_scale"):
            torch.testing.assert_close(a[k], b[k], **close)
    torch.testing.assert_close(sc0, sc1, **close)
    for k in p0:
        assert (p0[k] - p1[k]).abs().max().item() <= 5 * lr, k
    for slot in ("mean", "var"):
        for k in s1[slot]:
            torch.testing.assert_close(
                s0[slot][k], s1[slot][k], rtol=0,
                atol=GRAD_TOL * s1[slot][k].abs().max().item())


@pytest.mark.cuda
def test_eager_decode_and_train_step_make_no_host_sync(cuda):
    """The steps the graphs capture read nothing back to the host (the
    embedding's sorted backward included): sync debug mode "error" raises
    on any synchronising call."""
    port = _graph_lm(cuda)
    prompt = _prompt(cuda)
    s = lm._prompt_state(port, prompt, 2, _gen(cuda, 4))
    seq = torch.randint(0, 64, (2, 129), device=cuda,
                        generator=_gen(cuda, 3))
    adam = AdamOptimizer(learning_rate=1e-3)
    step = port.make_train_step(adam)._eager
    state = adam.init(dict(port.named_parameters()))
    lm._token_step(port, s, 1.0)                         # warm-up
    step(state, seq[:, :-1], seq[:, 1:], 1024.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lm._token_step(port, s, 1.0)
        port.decode_forward(s["logits"].argmax(-1), s["caches"], 22)
        step(state, seq[:, :-1], seq[:, 1:], 1024.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_failed_capture_raises_and_keeps_no_graph(cuda, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, no graph is kept, nothing runs the loop or the step
    eagerly instead, and the default generator still draws (F5)."""
    port = _graph_lm(cuda)
    logits = port._logits

    def reads_back(x):
        out = logits(x)
        float(out.sum())
        return out
    monkeypatch.setattr(port, "_logits", reads_back)
    with pytest.raises(RuntimeError):
        generate_cached_scan(port, _prompt(cuda), 2, generator=_gen(cuda, 1))
    assert not port._decode_graphs
    seq = torch.randint(0, 64, (2, 129), device=cuda,
                        generator=_gen(cuda, 3))
    adam = AdamOptimizer(learning_rate=1e-3)
    step = port.make_train_step(adam)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(RuntimeError):
        step(adam.init(dict(port.named_parameters())), seq[:, :-1],
             seq[:, 1:], 1024.0)
    assert not step._graphs
    torch.cuda.synchronize()
    assert all(torch.equal(v, before[k]) for k, v in port.state_dict().items())
    assert torch.randn(4, device=cuda).isfinite().all()   # F5


# ---------------- the unfused attention ops (kernels/bst_trio.py) ----------

def _trio_op(bs, ctx_blks, heads, per_head, seed, impl=None):
    """An op over a random layout, per head or shared, with the same block
    count in every head, whose query row 1 and key row 2 hold no block
    and whose query row 0 holds ctx_blks - 1 entries."""
    rng = np.random.RandomState(seed)
    lays = []
    for _ in range(heads if per_head else 1):
        lay = (rng.rand(ctx_blks, ctx_blks) < 0.4).astype(np.int32)
        lay[0, :] = 1
        lay[1, :] = 0
        lay[:, 2] = 0
        lays.append(lay)
    want = min(int(lay.sum()) for lay in lays)
    for lay in lays:                     # trim each head to `want` blocks
        on = np.flatnonzero(lay[2:].ravel())
        flat = lay[2:].ravel()
        flat[on[:int(lay.sum()) - want]] = 0
        lay[2:] = flat.reshape(lay[2:].shape)
    layout = np.array(lays) if per_head else lays[0]
    return BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=causal_subblock_mask,
                                  impl=impl)


def _plain_twin(port):
    """The same op on the plain versions (impl="xla"), by pickling."""
    twin = copy.copy(port)
    twin.impl = "xla"
    return twin


def _trio_tol(dtype, ref):
    tol = F32_TOL if dtype == torch.float32 else BSMM_BF16_TOL
    return tol * max(1.0, ref.float().abs().max().item())


def _trio_counts():
    return (bst_trio.bst_nt.launches, bst_trio.bst_xn.launches,
            bst_trio.bst_xn.launches_tn)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_head"])
@pytest.mark.parametrize("hs", [16, 64, 136, 256])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_trio_kernels_match_plain(cuda, dtype, bs, hs, layout):
    """nt, nn and tn on the kernels against their plain versions, on q, k
    and v sliced from one packed qkv (strided rows) over a layout with an
    empty query row and an empty key row (zeros there), each launching
    its kernel once, two runs equal bit for bit."""
    # query row 0 spans more than the three slots of the xn kernels' ring
    heads, blks = 2, 4 + 3 * 64 // bs
    port = _trio_op(bs, blks, heads, layout == "per_head", seed=bs + hs)
    plain = _plain_twin(port)
    g = torch.Generator(device=cuda).manual_seed(bs * hs)
    ctx = blks * bs
    qkv = torch.randn((2, ctx, 3 * heads * hs), device=cuda,
                      generator=g).to(dtype)
    q, k, v = qkv.split(heads * hs, dim=-1)
    w = torch.randn((2, heads, port.blocks, bs, bs), device=cuda,
                    generator=g).to(dtype)
    with torch.no_grad():
        for name, fn, moved in (
                ("nt", lambda op: op.nt_op(q, k), (1, 0, 0)),
                ("nn", lambda op: op.nn_op(w, v), (0, 1, 0)),
                ("tn", lambda op: op.tn_op(w, q), (0, 1, 1))):
            before = _trio_counts()
            got = fn(port)
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_trio_counts(), before)) \
                == moved, name
            ref = fn(plain)
            assert got.shape == ref.shape and got.dtype == dtype, name
            torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                       atol=_trio_tol(dtype, ref), msg=name)
            assert torch.equal(fn(port), got), name
    y = port.nn_op(w, v)
    assert (y[:, bs:2 * bs] == 0).all()                 # query row 1
    assert (port.tn_op(w, q)[:, 2 * bs:3 * bs] == 0).all()   # key row 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_trio_autograd_runs_kernels(cuda, dtype):
    """The gradients of nt, nn and tn (each one's backward is the other
    two) on the kernels against the plain twin's."""
    heads, bs, hs = 2, 32, 72
    port = _trio_op(bs, 6, heads, True, seed=7)
    plain = _plain_twin(port)
    g = torch.Generator(device=cuda).manual_seed(8)
    ctx = 6 * bs
    a0, b0, dy = (torch.randn((2, ctx, heads * hs), device=cuda,
                              generator=g).to(dtype) for _ in range(3))
    w0, dw = (torch.randn((2, heads, port.blocks, bs, bs), device=cuda,
                          generator=g).to(dtype) for _ in range(2))
    for name, fn, d in (("nt", lambda op, w, a, b: op.nt_op(a, b), dw),
                        ("nn", lambda op, w, a, b: op.nn_op(w, b), dy),
                        ("tn", lambda op, w, a, b: op.tn_op(w, a), dy)):
        grads = []
        for op in (port, plain):
            w, a, b = (t.detach().clone().requires_grad_()
                       for t in (w0, a0, b0))
            before = _trio_counts()
            fn(op, w, a, b).backward(d)
            torch.cuda.synchronize()
            moved = sum(x - y for x, y in zip(_trio_counts()[:2], before))
            assert moved == (3 if op is port else 0), name
            grads.append([t.grad for t in (w, a, b)])
        for got, ref in zip(*grads):
            assert (got is None) == (ref is None), name
            if ref is not None:
                assert got.dtype == dtype
                torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                           atol=_trio_tol(dtype, ref),
                                           msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("hs,use_fused,flash_bwd", [
    (64, False, True), (64, None, False), (256, None, True)])
def test_unfused_attention_on_the_card(cuda, dtype, hs, use_fused,
                                       flash_bwd):
    """use_fused=False, flash_bwd=False and a head size past 128 (the
    unfused ops by default) on the card: the trio's kernels run (the
    fused backward's do not) and forward and gradients match the plain
    twin's."""
    heads, bs, blks = 2, 32, 6
    port = BlocksparseTransformer(fixed_layout(blks, local_blocks=2),
                                  block_size=bs, heads=heads,
                                  mask_callback=causal_subblock_mask)
    plain = _plain_twin(port)
    g = torch.Generator(device=cuda).manual_seed(hs)
    qkv = torch.randn((2, blks * bs, 3 * heads * hs), device=cuda,
                      generator=g).to(dtype)
    do = torch.randn((2, blks * bs, heads * hs), device=cuda,
                     generator=g).to(dtype)
    outs = []
    for op in (port, plain):
        q, k, v = (t.detach().requires_grad_()
                   for t in qkv.split(heads * hs, dim=-1))
        before = _trio_counts() + (bst_attn.attention_dq.launches,)
        out = op.attention(q, k, v, scale=hs ** -0.5, use_fused=use_fused,
                           flash_bwd=flash_bwd)
        out.backward(do)
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip(
            _trio_counts() + (bst_attn.attention_dq.launches,), before)]
        if op is port:
            # nt and nn forward (recomputed without flash_bwd), nn's
            # backward (nt, tn) and nt's (nn, tn)
            assert moved == [2, 4, 2, 0]
        else:
            assert not any(moved)
        outs.append([out, q.grad, k.grad, v.grad])
    for name, got, ref in zip(("y", "dq", "dk", "dv"), *outs):
        tol = F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
        torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                   atol=tol * max(1.0, ref.float().abs()
                                                  .max().item()), msg=name)


def _long_row_op(bs, ctx_blks, heads, per_head, seed):
    """An op over a sparse random layout (per head or shared, the same
    block count in each) whose query row 0 and key row 0 hold every
    block, far more than twice the mean: the launch plan cuts both in
    two.  Query row 1 and key row 2 hold no block."""
    rng = np.random.RandomState(seed)
    lays = []
    for _ in range(heads if per_head else 1):
        lay = (rng.rand(ctx_blks, ctx_blks) < 0.1).astype(np.int32)
        lay[1, :] = 0
        lay[:, 2] = 0
        lay[0, :] = 1
        lay[:, 0] = 1
        lay[1, 0] = lay[0, 2] = 0
        lays.append(lay)
    want = min(int(lay.sum()) for lay in lays)
    for lay in lays:
        on = np.argwhere(lay[3:, 3:])[:int(lay.sum()) - want] + 3
        lay[on[:, 0], on[:, 1]] = 0
    layout = np.array(lays) if per_head else lays[0]
    return BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                  mask_callback=causal_subblock_mask)


def _trio_holds(port, fns, dtype):
    """Each (name, fn) on the kernels against the plain twin, one launch
    of its kernel, two runs equal bit for bit."""
    plain = _plain_twin(port)
    with torch.no_grad():
        for name, fn, moved in fns:
            before = _trio_counts()
            got = fn(port)
            torch.cuda.synchronize()
            assert tuple(a - b for a, b in zip(_trio_counts(), before)) \
                == moved, name
            ref = fn(plain)
            assert got.shape == ref.shape and got.dtype == dtype, name
            torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                                       atol=_trio_tol(dtype, ref), msg=name)
            assert torch.equal(fn(port), got), name


def _qkvw(port, hs, dtype, seed, batch=2):
    g = torch.Generator(device="cuda").manual_seed(seed)
    heads, bs = port.heads, port.blk_size
    qkv = torch.randn((batch, port.ctx_blks_q * bs, 3 * heads * hs),
                      device="cuda", generator=g).to(dtype)
    q, k, v = qkv.split(heads * hs, dim=-1)
    w = torch.randn((batch, heads, port.blocks, bs, bs), device="cuda",
                    generator=g).to(dtype)
    return q, k, v, w


@pytest.mark.cuda
@pytest.mark.parametrize("hs", [8, 72, 136, 264, 512])
@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_trio_nt_head_sizes(cuda, dtype, bs, hs):
    """NT around its 64-column chunks of the head (one k16 step at hs 8,
    a chunk of 8 columns past 64 and past 256) and at its limit of 512,
    per-head layouts with an empty row, against the plain version."""
    port = _trio_op(bs, 6, 2, True, seed=hs)
    q, k, _, _ = _qkvw(port, hs, dtype, seed=hs + bs)
    _trio_holds(port, [("nt", lambda op: op.nt_op(q, k), (1, 0, 0))], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_head"])
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_trio_xn_past_one_column_group(cuda, dtype, bs, layout):
    """NN and TN at hs 320: two column groups (256 and 64 columns), the
    second's last warps idle; empty rows write zeros."""
    hs = 320
    port = _trio_op(bs, 5, 2, layout == "per_head", seed=bs)
    q, _, v, w = _qkvw(port, hs, dtype, seed=bs)
    _trio_holds(port, [("nn", lambda op: op.nn_op(w, v), (0, 1, 0)),
                       ("tn", lambda op: op.tn_op(w, q), (0, 1, 1))], dtype)
    assert (port.nn_op(w, v)[:, bs:2 * bs] == 0).all()
    assert (port.tn_op(w, q)[:, 2 * bs:3 * bs] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_head"])
@pytest.mark.parametrize("bs,ctx_blks", [(64, 36), (8, 68)])
@pytest.mark.parametrize("dtype", HALF)
def test_trio_long_rows_split(cuda, dtype, bs, ctx_blks, layout):
    """A query row and a key row of ctx_blks - 1 entries (35 at b64, 67
    at b8), cut in two by the launch plan: NT writes each half, NN and TN
    sum the halves across a cluster; against the plain version, two runs
    equal bit for bit, empty rows zeros."""
    port = _long_row_op(bs, ctx_blks, 2, layout == "per_head", seed=bs)
    tri = bst_trio.trio_tables(port.nt_list, ctx_blks, ctx_blks)
    for name in ("plan", "plan_t"):
        items = tri[name][port.lut_heads * (ctx_blks + 1):]
        assert (items[items >= 0] % 4 == bst_trio.FIRST).any(), name
    q, k, v, w = _qkvw(port, 64, dtype, seed=ctx_blks)
    _trio_holds(port, [("nt", lambda op: op.nt_op(q, k), (1, 0, 0)),
                       ("nn", lambda op: op.nn_op(w, v), (0, 1, 0)),
                       ("tn", lambda op: op.tn_op(w, q), (0, 1, 1))], dtype)
    assert (port.nn_op(w, v)[:, bs:2 * bs] == 0).all()
    assert (port.tn_op(w, q)[:, 2 * bs:3 * bs] == 0).all()


@pytest.mark.cuda
def test_trio_raises_and_never_falls_back(cuda):
    """The wrappers raise on CPU tensors, on a head size that is not a
    multiple of 8, on mismatched weights and on row pointers without
    their launch plan; nothing counts."""
    port = _trio_op(16, 4, 2, False, seed=1)
    tab = port._tables(cuda)
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((1, 64, 2 * 16), device=cuda, generator=g)
    before = _trio_counts()
    with pytest.raises(ValueError):
        bst_trio.bst_nt(q.cpu(), q.cpu(), tab["tri_plan"],
                        tab["tri_ent_k"], 2, 16)
    with pytest.raises(ValueError):
        bst_trio.bst_nt(q[..., :20], q[..., :20], tab["tri_plan"],
                        tab["tri_ent_k"], 2, 16)
    with pytest.raises(ValueError, match="launch plan"):
        bst_trio.bst_nt(q, q, tab["tri_row_ptr"], tab["tri_ent_k"], 2, 16)
    w = torch.randn((1, 2, port.blocks + 1, 16, 16), device=cuda,
                    generator=g)
    with pytest.raises(ValueError):
        bst_trio.bst_xn(w, q, tab["tri_plan"], tab["tri_ent_e"],
                        tab["tri_ent_k"], 2, 16, 4, False)
    with pytest.raises(ValueError, match="launch plan"):
        bst_trio.bst_xn(w[:, :, :-1].contiguous(), q, tab["tri_row_ptr_t"],
                        tab["tri_ent_b"], tab["tri_ent_q"], 2, 16, 4, True)
    assert _trio_counts() == before


@pytest.mark.cuda
def test_captured_hs256_train_step_equals_eager_step(cuda):
    """The LM at 2 heads of 256 (the unfused ops: nt, nn and tn on the
    kernels) captured as one CUDA graph: two replayed steps equal two
    eager steps of the same model bit for bit (metrics, scale, Adam's
    slots, parameters)."""
    kw = dict(n_vocab=64, n_embd=512, n_layer=2, n_head=2, ctx=128,
              blk_size=32, attn_layout="fixed", local_blocks=2, mlp_ratio=2,
              mlp_block_size=32, mlp_density=0.5, dtype="bfloat16",
              recompute=True)
    models = []
    for _ in range(2):
        m = SparseTransformerLM(TransformerConfig(**kw), device=cuda)
        m.load_state_dict(params_from_jax(random_jax_params(m, seed=5), m))
        models.append(m)
    seq = torch.randint(0, 64, (2, 129), device=cuda,
                        generator=_gen(cuda, 6))
    adam = AdamOptimizer(learning_rate=1e-3, zero_nans=True, zero_infs=True)
    runs = []
    for m, graph in zip(models, (True, False)):
        step = m.make_train_step(adam)
        fn = step if graph else step._eager
        state, scale, metrics = adam.init(dict(m.named_parameters())), \
            1024.0, []
        before = _trio_counts()
        for _ in range(2):
            state, mt, scale = fn(state, seq[:, :-1], seq[:, 1:], scale)
            metrics.append(mt)
        torch.cuda.synchronize()
        moved = [a - b for a, b in zip(_trio_counts(), before)]
        # per step: nt 3L (forward, recompute, nn's backward), xn 5L of
        # which tn 2L; the graph's first call runs the warm-up's eager step
        # and the captured one, its second call is a replay
        L = kw["n_layer"]
        assert moved == [6 * L, 10 * L, 4 * L], (graph, moved)
        runs.append((state, metrics, scale, m.state_dict()))
    (s0, m0, sc0, p0), (s1, m1, sc1, p1) = runs
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "norm_scale"):
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(sc0, sc1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for slot in ("mean", "var"):
        assert all(torch.equal(s0[slot][k], s1[slot][k]) for k in s1[slot])


@pytest.mark.cuda
def test_lm_past_head_size_128_matches_plain_model(cuda):
    """The LM at 2 heads of 256 takes the unfused ops on the card: its
    forward launches nt and nn once a layer and no fused kernel, and its
    logits and one train step match the impl="xla" model's."""
    cfg = TransformerConfig(
        n_vocab=64, n_embd=512, n_layer=2, n_head=2, ctx=128, blk_size=32,
        attn_layout="fixed", local_blocks=2, mlp_ratio=2, mlp_block_size=32,
        mlp_density=0.5, dtype="bfloat16", recompute=True)
    models = [SparseTransformerLM(cfg, device=cuda),
              SparseTransformerLM(cfg, device=cuda, impl="xla")]
    sd = params_from_jax(random_jax_params(models[0], seed=3), models[0])
    for m in models:
        m.load_state_dict(sd)
    g = torch.Generator(device=cuda).manual_seed(4)
    seq = torch.randint(0, 64, (2, 129), device=cuda, generator=g)
    before = _trio_counts() + (bst_attn.attention_fwd.launches,)
    logits = models[0](seq[:, :-1])
    torch.cuda.synchronize()
    moved = [a - b for a, b in zip(
        _trio_counts() + (bst_attn.attention_fwd.launches,), before)]
    assert moved == [2, 2, 0, 0]
    ref = models[1](seq[:, :-1])
    torch.testing.assert_close(logits, ref, rtol=0, atol=2e-2 * max(
        1.0, ref.abs().max().item()))
    adam = AdamOptimizer(learning_rate=1e-3)
    metrics = []
    for m in models:
        step = m.make_train_step(adam)
        _, met, _ = step._eager(adam.init(dict(m.named_parameters())),
                                seq[:, :-1], seq[:, 1:], 1024.0)
        metrics.append(met)
    for key in ("loss", "grad_norm"):
        a, b = metrics[0][key].item(), metrics[1][key].item()
        assert np.isfinite(a) and abs(a - b) <= 1e-2 * abs(b), key


# ---------------- the training surface: 16-bit slots, dropout, ----------
# ---------------- quantize, Adafactor and EMA on the card ----------------

def _probe16(unpacked, seed):
    """Every code's value, its neighbours, and a seeded spread."""
    vals = unpacked[torch.isfinite(unpacked)]
    g = torch.Generator().manual_seed(seed)
    spread = torch.randn(20000, generator=g) * torch.pow(
        10.0, torch.rand(20000, generator=g) * 27 - 25)
    return torch.cat([vals, torch.nextafter(vals, torch.tensor(np.inf)),
                      torch.nextafter(vals, torch.tensor(-np.inf)), spread,
                      torch.tensor([0.0, -0.0, 16.0, 2.0 ** -61])])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["mhalf", "vhalf"])
def test_packed16_on_the_card_equals_the_cpu(cuda, fmt):
    """All 65,536 codes unpack on the card to the CPU's f32 bits, and a
    seeded set with every code's value, its neighbours and edge values
    packs to the CPU's codes."""
    from blocksparse_tpu_torch.ops import optimize as port_opt
    unpack, pack = (getattr(port_opt, f"{fmt}_{d}")
                    for d in ("unpack", "pack"))
    codes = torch.arange(65536, dtype=torch.int32).to(torch.uint16)
    cpu = unpack(codes)
    dev = unpack(codes.to(cuda))
    assert torch.equal(dev.cpu().view(torch.int32), cpu.view(torch.int32))
    x = _probe16(cpu, 0)
    assert torch.equal(pack(x.to(cuda)).cpu().view(torch.int16),
                       pack(x).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bfloat16", "packed16"])
def test_captured_train_step_with_16_bit_slots_equals_eager_step(cuda, fmt):
    """The captured step with 16-bit Adam slots (packed16 codes unpacked,
    updated and packed inside the graph) against the eager step, two
    steps from the same weights: metrics, scale, every slot and every
    parameter equal bit for bit."""
    kw = dict(GRAPH_LM, recompute=True)
    seq = torch.randint(0, 64, (2, 129), device=cuda,
                        generator=_gen(cuda, 3))
    adam = AdamOptimizer(learning_rate=1e-3, zero_nans=True,
                         zero_infs=True, state_format=fmt)
    runs = []
    for graph in (True, False):
        m = SparseTransformerLM(TransformerConfig(**kw), device=cuda)
        m.load_state_dict(params_from_jax(random_jax_params(m, seed=7), m))
        step = m.make_train_step(adam)
        fn = step if graph else step._eager
        state, scale, metrics = adam.init(dict(m.named_parameters())), \
            1024.0, []
        for _ in range(2):
            state, mt, scale = fn(state, seq[:, :-1], seq[:, 1:], scale)
            metrics.append(mt)
        torch.cuda.synchronize()
        runs.append((state, metrics, scale, m.state_dict()))
    (s0, m0, sc0, p0), (s1, m1, sc1, p1) = runs
    want = torch.uint16 if fmt == "packed16" else torch.bfloat16
    assert s0["mean"]["h.0.w_qkv"].dtype == want
    assert s0["mean"]["h.0.ln1_g"].dtype == torch.float32
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "norm_scale"):
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(sc0, sc1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for slot in ("mean", "var"):      # uint16 slots compared as int16
        assert all(torch.equal(s0[slot][k].view(torch.int16),
                               s1[slot][k].view(torch.int16))
                   if s1[slot][k].dtype == torch.uint16
                   else torch.equal(s0[slot][k], s1[slot][k])
                   for k in s1[slot])


@pytest.mark.cuda
def test_dropout_on_the_card_draws_before_each_checkpoint(cuda):
    """loss with resid_pdrop 0.1 and a card generator: the same loss for
    the same seed, the same gradients with recompute on and off, and a
    kept share within binomial bounds."""
    port = _graph_lm(cuda, resid_pdrop=0.1, dtype="float32")
    seq = torch.randint(0, 64, (2, 129), device=cuda,
                        generator=_gen(cuda, 3))
    names, params = zip(*port.named_parameters())
    runs = []
    for recompute in (True, True, False):
        port.config.recompute = recompute
        loss = port.loss(seq[:, :-1], seq[:, 1:], dropout=_gen(cuda, 9))
        runs.append((loss, torch.autograd.grad(loss, params)))
    (l0, g0), (l1, _), (l2, g2) = runs
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    assert all(torch.equal(a, b) for a, b in zip(g0, g2))
    masks = port._dropout_masks(_gen(cuda, 9), 0, (2, 128, 256), cuda)
    n = masks[0].numel()
    for m in masks:
        assert m.is_cuda
        assert abs(m.float().mean().item() - 0.9) < 5 * np.sqrt(
            0.9 * 0.1 / n)


@pytest.mark.cuda
def test_random_ops_without_a_generator_draw_on_the_card(cuda):
    """The global entropy keeps a generator a device, each from the one
    seed: dropout and stochastic quantize of a tensor on the card draw
    there, and recompute replays those draws."""
    x = torch.ones(64, 256, device=cuda)
    bt.set_entropy(4)
    y, m = bt.dropout(x, 0.6)
    assert bt.get_entropy(cuda).device.type == "cuda" and m.is_cuda
    assert bt.get_entropy().device.type == "cpu"
    want = torch.rand(x.shape, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(4)) < 0.6
    assert torch.equal(m, want)
    bt.set_entropy(4)
    assert torch.equal(bt.dropout(x, 0.6)[1], m)
    spec = bt.QuantizeSpec(ebits=4, fbits=3, emax=7, stochastic=1)

    @bt.recomputable
    def block(a):
        return (bt.quantize(bt.dropout(a, 0.6)[0], spec) ** 2).sum()
    grads = []
    for recompute in (False, True):
        bt.set_entropy(5)
        a = (x * 0.37).requires_grad_()
        grads.append(torch.autograd.grad(block(a, recompute=recompute), a))
    assert torch.equal(grads[0][0], grads[1][0])


@pytest.mark.cuda
def test_quantize_adafactor_and_ema_on_the_card_match_the_cpu(cuda):
    from blocksparse_tpu_torch import (AdafactorOptimizer, Ema,
                                       QuantizeSpec, quantize)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4096, generator=g) * torch.pow(
        2.0, torch.rand(4096, generator=g) * 60 - 40)
    for spec in (QuantizeSpec(ebits=4, fbits=3), QuantizeSpec(ebits=5,
                                                              fbits=10),
                 QuantizeSpec(ebits=8, fbits=7, emax=127)):
        assert torch.equal(quantize(x.to(cuda), spec).cpu(),
                           quantize(x, spec))
    params = {"w": torch.randn(64, 48, generator=g),
              "b": torch.randn(48, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in
              params.items()} for _ in range(3)]
    for opt in (AdafactorOptimizer(learning_rate=0.01),):
        out = []
        for dev in ("cpu", cuda):
            p = {k: v.to(dev) for k, v in params.items()}
            s = opt.init(p)
            for gr in grads:
                p, s = opt.apply({k: v.to(dev) for k, v in gr.items()}, p, s)
            out.append(p)
        for k in params:
            torch.testing.assert_close(out[1][k].cpu(), out[0][k],
                                       rtol=1e-5, atol=1e-6)
    ema = Ema(decay=0.9)
    e_cpu = ema.apply(params, ema.init(params))
    e_dev = ema.apply({k: v.to(cuda) for k, v in params.items()},
                      ema.init({k: v.to(cuda) for k, v in params.items()}))
    for k in params:
        torch.testing.assert_close(e_dev[k].cpu(), e_cpu[k], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.cuda
def test_profiling_on_the_card(cuda, tmp_path, capsys):
    """Benchmark and bench_op time by CUDA events, trace records the
    card's kernels, memory_analysis and live_buffers read the caching
    allocator."""
    from blocksparse_tpu_torch import profiling
    g = _gen(cuda, 11)
    x = torch.randn(1024, 1024, device=cuda, generator=g)
    w = torch.randn(1024, 1024, device=cuda, generator=g) / 32
    with profiling.Benchmark("mm", flops=2 * 1024 ** 3, repeat=4) as b:
        for _ in range(4):
            x @ w
    assert b.ms > 0 and "GFLOPS (mm)" in capsys.readouterr().out
    s = profiling.bench_op(lambda a, m: torch.tanh(a @ m), x, w, iters=8)
    assert 0 < s < 1.0
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        torch.tanh(x @ w)
    text = open(tmp_path / "tr" / "trace.json").read()
    assert logdir == str(tmp_path / "tr") and '"cat": "kernel"' in text
    mem = profiling.memory_analysis(lambda a: (a @ w).relu(), x)
    assert mem["argument_size"] == 4 * 1024 * 1024
    assert mem["output_size"] == 4 * 1024 * 1024
    assert mem["peak_estimate"] >= mem["argument_size"] + mem["output_size"]
    live = profiling.live_buffers()
    assert live["total_bytes"] >= 8 * 1024 * 1024
    assert any(s == (1024, 1024) for s, _, _ in
               live["per_device"][str(x.device)])


# ---------------- F5: a failed capture leaves the process usable ----------

@pytest.mark.cuda
def test_a_failed_capture_keeps_the_default_generator_drawing(cuda):
    """A host sync inside a capture fails it; ``capture_graph`` raises the
    error, and afterwards the default CUDA generator draws
    (``torch.randn``) and a good capture replays (F5: torch's
    ``capture_end`` raises before the generator's capture epilogue)."""
    x = torch.ones(8, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))

    def syncs():
        float((x * 2).sum())
    with pytest.raises(RuntimeError):
        lm.capture_graph(side, syncs)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.randn(16, device=cuda).isfinite().all()
    out = {}

    def body():
        out["y"] = x * 3 + torch.randn(8, device=cuda)
    graph = lm.capture_graph(side, body)
    graph.replay()
    first = out["y"].clone()
    graph.replay()
    torch.cuda.synchronize()
    assert first.isfinite().all() and not torch.equal(first, out["y"])
    assert torch.randn(16, device=cuda).isfinite().all()


# ---------------- the gated matmul on the kernels ----------------

GATE_PAIRS = [(False, False), (False, True), (True, False), (True, True)]


def _gated_run(op, x, w, gate, e, **kw):
    x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
    g = gate.clone().requires_grad_(isinstance(gate, torch.Tensor)) \
        if isinstance(gate, torch.Tensor) else gate
    y = op(x, w, gate=g, **kw)
    args = (x, w, g) if isinstance(g, torch.Tensor) else (x, w)
    grads = torch.autograd.grad((y.float() * e).sum(), args)
    return (y,) + grads


@pytest.mark.cuda
@pytest.mark.parametrize("dw_gated,gate_grad", GATE_PAIRS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_kernels_match_plain(cuda, dtype, axis, dw_gated, gate_grad):
    """y, dx, dw and dg of the dynamic gate on the kernels against the
    plain op: y and dx at the matmul's tolerance, dw and dg (f32 sums of
    the same products) at the updat's (bf16 dw one rounding more)."""
    g = _gen(cuda, 31)
    layout = random_layout(12, 20, 0.4, seed=5)
    ops = [BlocksparseMatMul(layout, block_size=32, feature_axis=axis,
                             impl=impl) for impl in (None, "xla")]
    N = 384
    x = torch.randn(ops[0].i_shape(N), device=cuda, generator=g).to(dtype)
    w = (torch.randn(ops[0].w_shape, device=cuda, generator=g)
         * 0.1).to(dtype)
    e = torch.randn(ops[0].o_shape(N), device=cuda, generator=g)
    gate = (torch.rand(ops[0].blocks, device=cuda, generator=g) > 0.4) \
        .float()
    got, want = (_gated_run(op, x, w, gate, e, dw_gated=dw_gated,
                            gate_grad=gate_grad) for op in ops)
    tol = F32_TOL if dtype == torch.float32 else BSMM_BF16_TOL
    dw_tol = UPDAT_TOL if dtype == torch.float32 else BSMM_BF16_TOL
    for a, b, t in zip(got, want, (tol, tol, dw_tol, UPDAT_TOL)):
        assert a.dtype == b.dtype
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= t * scale
    if not gate_grad:
        assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_static_gate_on_the_kernels(cuda, dtype):
    """A NumPy gate runs the kernels over the surviving blocks only: y, dx
    and dw against the dynamic gate's on the kernels, at the matmul's
    tolerances; launches of the sub-op's LUT; the all-zero gate gives
    zeros and launches nothing."""
    g = _gen(cuda, 32)
    op = BlocksparseMatMul(random_layout(16, 16, 0.5, seed=6),
                           block_size=32, feature_axis=1)
    N = 512
    x = torch.randn(op.i_shape(N), device=cuda, generator=g).to(dtype)
    w = (torch.randn(op.w_shape, device=cuda, generator=g) * 0.1).to(dtype)
    e = torch.randn(op.o_shape(N), device=cuda, generator=g)
    gate = (np.random.RandomState(3).rand(op.blocks) > 0.5) \
        .astype(np.float32)
    dyn = _gated_run(op, x, w, torch.as_tensor(gate, device=cuda), e,
                     dw_gated=True)[:3]
    static = _gated_run(op, x, w, gate, e, dw_gated=True)
    sub = op._static_gates[gate.tobytes()].sub
    assert sub.blocks == int(gate.sum())
    tol = F32_TOL if dtype == torch.float32 else BSMM_BF16_TOL
    for a, b in zip(static, dyn):
        scale = max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
    before = bsmm_kernels.bsmm_fprop.launches + \
        bsmm_kernels.bsmm_split.launches + bsmm_kernels.bsmm_updat.launches
    zero = np.zeros(op.blocks, np.float32)
    y, dx, dw = _gated_run(op, x, w, zero, e, dw_gated=True)
    assert not y.any() and not dx.any() and not dw.any()
    assert before == bsmm_kernels.bsmm_fprop.launches + \
        bsmm_kernels.bsmm_split.launches + bsmm_kernels.bsmm_updat.launches


# ---------------- the sparse LSTM on the kernels ----------------

LSTM_SMALL = dict(nhidden=256, nembd=32, nproj_in=128, nproj_out=128,
                  nsteps=6, block_size=32, mask_kind="ba_2", isteps=2,
                  lsteps=2, share_masks=False, n_vocab=64)


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [False, True])
def test_sparse_lstm_on_the_kernels_matches_the_plain_model(cuda,
                                                             recompute):
    """The model's loss and every gradient on the f32 CN kernels against
    the plain-version model from the same params: 1e-5 relative on the
    loss, 1e-4 of each gradient's largest (f32 sums in other orders over
    every application of the shared w_h); the kernels launched."""
    models = []
    for impl in (None, "xla"):
        m = SparseLSTM(LSTMConfig(**LSTM_SMALL, recompute=recompute),
                       device=cuda, impl=impl)
        m.load_state_dict(lstm_params_from_jax(
            random_jax_lstm_params(m, seed=3), m))
        models.append(m)
    tokens = torch.randint(0, 64, (16, 6), device=cuda,
                           generator=_gen(cuda, 9))
    targets = torch.randint(0, 64, (16, 6), device=cuda,
                            generator=_gen(cuda, 10))
    before = (bsmm_kernels.bsmm_fprop.launches,
              bsmm_kernels.bsmm_updat.launches)
    out = []
    for m in models:
        names, params = zip(*m.named_parameters())
        loss = m.loss(tokens, targets)
        out.append((loss, dict(zip(names,
                                   torch.autograd.grad(loss, params)))))
    (l0, g0), (l1, g1) = out
    assert bsmm_kernels.bsmm_fprop.launches > before[0]
    assert bsmm_kernels.bsmm_updat.launches > before[1]
    assert abs(l0.item() - l1.item()) <= 1e-5 * abs(l1.item())
    for k, g in g1.items():
        assert (g0[k] - g).abs().max().item() <= \
            UPDAT_TOL * g.abs().max().item(), k


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_mixed_dtype_bsmm_runs_the_f32_kernels(cuda, axis):
    """bf16 x with f32 W (the MoE's experts, ROADMAP F6): fprop and bprop
    run the f32 kernel on the upcast operand and round to x's dtype, dw is
    f32; against the plain op's (the JAX product) within one bf16
    rounding, dw within the updat's tolerance."""
    layout = random_layout(4, 8, 0.5, seed=7)
    op = BlocksparseMatMul(layout, block_size=32, feature_axis=axis)
    ref = BlocksparseMatMul(layout, block_size=32, feature_axis=axis,
                            impl="xla")
    g = _gen(cuda, 21)
    shape = (300, op.C) if axis else (op.C, 300)
    x = torch.randn(shape, device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn(op.w_shape, device=cuda, generator=g) * 0.1
    outs = []
    before = bsmm_kernels.bsmm_fprop.launches
    for o in (op, ref):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = o(xr, wr)
        dy = torch.ones_like(y)
        outs.append((y, *torch.autograd.grad(y, (xr, wr), dy)))
    assert bsmm_kernels.bsmm_fprop.launches == before + 1
    (y, dx, dw), (ry, rdx, rdw) = outs
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for a, b in ((y, ry), (dx, rdx)):
        assert (a.float() - b.float()).abs().max().item() <= \
            1e-2 * max(1.0, b.float().abs().max().item())
    assert (dw - rdw).abs().max().item() <= UPDAT_TOL * rdw.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_on_the_card_matches_the_plain_layer(cuda, k):
    """BlocksparseMoE on the kernels against impl="xla" from the same
    params and bf16 tokens (one routing: the router is plain torch in
    both): y, aux and every gradient within the matmul's tolerances,
    F6's dtypes, two runs equal bit for bit (no float atomics)."""
    from blocksparse_tpu_torch.ops.moe import BlocksparseMoE
    kw = dict(block_size=32, density=0.5, capacity_factor=1.0, k=k)
    moe, plain = BlocksparseMoE(4, 64, 128, **kw), \
        BlocksparseMoE(4, 64, 128, impl="xla", **kw)
    params = moe.init(_gen(cuda, 22), device=cuda)
    x = torch.randn((512, 64), device=cuda,
                    generator=_gen(cuda, 23)).to(torch.bfloat16)
    dy = torch.randn((512, 64), device=cuda, generator=_gen(cuda, 24))
    runs = []
    for m in (moe, moe, plain):
        p = {n: t.clone().requires_grad_() for n, t in params.items()}
        xr = x.clone().requires_grad_()
        y, aux = m(p, xr)
        runs.append([y, aux] + list(torch.autograd.grad(
            (y, aux), [xr] + list(p.values()),
            (dy, torch.tensor(1.0, device=cuda)))))
    a, b, ref = runs
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].dtype == torch.float32 and a[2].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in a[3:])
    assert abs(a[1].item() - ref[1].item()) <= 1e-6
    for got, want in zip(a[:1] + a[2:], ref[:1] + ref[2:]):
        assert (got.float() - want.float()).abs().max().item() <= \
            1e-2 * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
def test_moe_lm_captured_step_equals_the_eager_step(cuda):
    """A small MoE LM's train step, one CUDA graph, equals its eager step
    bit for bit (metrics, scale, every parameter), and its replays launch
    through no wrapper."""
    cfg = TransformerConfig(**dict(GRAPH_LM, mlp_block_size=32,
                                   mlp_density=1.0, moe_experts=4, moe_k=2))
    model = SparseTransformerLM(cfg, device=cuda)
    model.load_state_dict(params_from_jax(random_jax_params(model, 5),
                                          model))
    tokens = torch.randint(0, cfg.n_vocab, (2, cfg.ctx), device=cuda,
                           generator=_gen(cuda, 25))
    opt = AdamOptimizer(learning_rate=1e-3)
    step = model.make_train_step(opt)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    _, m_e, sc_e = step._eager(opt.init(dict(model.named_parameters())),
                               tokens, tokens, 1024.0)
    after_e = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(start)
    state, m_c, sc_c = step(opt.init(dict(model.named_parameters())),
                            tokens, tokens, 1024.0)
    assert all(torch.equal(m_c[k], m_e[k]) for k in m_c)
    assert torch.equal(sc_c, sc_e)
    assert all(torch.equal(v, after_e[k])
               for k, v in model.state_dict().items())
    before = bsmm_kernels.bsmm_fprop.launches
    step(state, tokens, tokens, sc_c)
    assert bsmm_kernels.bsmm_fprop.launches == before


# ---------------- sequence parallelism: shard tables on the card

def _seq_case(device, dtype, bs, ctx_blks, heads=2, hs=64, batch=2):
    from blocksparse_tpu_torch.ops.transformer import _rowsum
    port, (q, k, v) = _fixed_case(device, dtype, batch=batch,
                                  ctx=ctx_blks * bs, bs=bs, heads=heads,
                                  hs=hs, local=3)
    g = torch.Generator(device=device).manual_seed(1)
    do = torch.randn(q.shape, device=device, generator=g).to(dtype)
    scale = 1.0 / np.sqrt(hs)
    y, lse = port._kernel_fwd(q, k, v, scale, True)
    dq, dk, dv = port._kernel_bwd(q, k, v, do, y, lse, scale)
    return port, (q, k, v, do), scale, (y, lse, dq, dk, dv), _rowsum


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
def test_attention_dq_f32_output(cuda, dtype):
    """``attention_dq(out_dtype=torch.float32)``: the epilogue stores the
    f32 accumulator, which rounds to the default output bit for bit, and
    matches the plain version's unrounded dq."""
    from blocksparse_tpu_torch.ops.transformer import _rowsum
    port, (q, k, v) = _fixed_case(cuda, dtype, ctx=512, bs=64)
    do = torch.randn(q.shape, device=cuda,
                     generator=_gen(cuda, 3)).to(dtype)
    y, lse = port._kernel_fwd(q, k, v, 0.125, True)
    tab = port._tables(cuda)
    dvec = _rowsum(do, y, port.heads)
    args = (q, k, v, do, lse, dvec, tab, port.heads, 0.125)
    before = bst_attn.attention_dq.launches
    dq = bst_attn.attention_dq(*args)
    dq32 = bst_attn.attention_dq(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert bst_attn.attention_dq.launches == before + 2
    assert dq.dtype == dtype and dq32.dtype == torch.float32
    assert torch.equal(dq32.to(dtype), dq)
    ref = bst_attn.attention_bwd_plain(
        q, k, v, do, lse, dvec, tab["q_blk"], tab["k_blk"], tab["mask"],
        port.heads, 64, 0.125, dq_dtype=torch.float32)[0]
    tol = F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    torch.testing.assert_close(dq32, ref, rtol=0,
                               atol=tol * max(1.0, ref.abs().max().item()))
    with pytest.raises(TypeError):
        bst_attn.attention_dq(*args, out_dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_gather_shard_kernels_match_the_unsharded_launch(cuda, n, dtype):
    """Each shard's fwd_lse, dq and dk/dv on its tables (q sliced, K/V
    whole): y, lse and dq equal the unsharded kernels' bit for bit (each
    row walks its entries in the same order); dk/dv, summed over the
    shards, within f32 rounding of the sums."""
    from blocksparse_tpu_torch.parallel import sequence as seq
    port, (q, k, v, do), scale, (y, lse, dq, dk, dv), rowsum = _seq_case(
        cuda, dtype, 64, 8)
    L = q.shape[1] // n
    ys, ls, dqs = [], [], []
    dks, dvs = torch.zeros_like(dk), torch.zeros_like(dv)
    before = (bst_attn.attention_fwd_lse.launches,
              bst_attn.attention_dq.launches,
              bst_attn.attention_dkv.launches)
    for r in range(n):
        tab = seq.shard_tables(port, n, r, None, cuda)
        sl = slice(r * L, (r + 1) * L)
        yr, lr = seq.shard_forward(port, q[:, sl], k, v, scale, tab)
        dqr, dkr, dvr = seq.shard_backward(
            port, q[:, sl], k, v, do[:, sl], rowsum(do[:, sl], yr,
                                                    port.heads),
            lr, scale, tab)
        ys.append(yr), ls.append(lr), dqs.append(dqr)
        dks += dkr
        dvs += dvr
    torch.cuda.synchronize()
    assert (bst_attn.attention_fwd_lse.launches,
            bst_attn.attention_dq.launches,
            bst_attn.attention_dkv.launches) == tuple(b + n for b in before)
    assert torch.equal(torch.cat(ys, 1), y)
    assert torch.equal(torch.cat(ls, 2), lse)
    assert torch.equal(torch.cat(dqs, 1), dq)
    for got, want in ((dks, dk), (dvs, dv)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=F32_TOL * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_shard_kernels_match_the_unsharded_launch(cuda, n, dtype):
    """The ring's n² pair launches merged by (out, lse), and its backward
    with dq in f32 summed over the key chunks, against the unsharded
    kernels: the merge and the sums add in other orders (f32, then one
    rounding to the dtype for y)."""
    from blocksparse_tpu_torch.parallel import sequence as seq
    port, (q, k, v, do), scale, (y, lse, dq, dk, dv), rowsum = _seq_case(
        cuda, dtype, 64, 8)
    L = q.shape[1] // n

    def cut(a, i):
        return a[:, i * L:(i + 1) * L]
    outs = []
    for r in range(n):
        out = torch.zeros(cut(q, r).shape, device=cuda)
        l = torch.full((q.shape[0], port.heads, L), -1e30, device=cuda)
        for j in range(n):
            o_t, l_t = seq.shard_forward(
                port, cut(q, r), cut(k, j), cut(v, j), scale,
                seq.shard_tables(port, n, r, j, cuda))
            out, l = seq.merge(out, l, o_t, l_t, port.heads)
        outs.append((out, l))
    dqs = [torch.zeros(cut(q, r).shape, device=cuda) for r in range(n)]
    dks, dvs = torch.zeros_like(dk), torch.zeros_like(dv)
    for j in range(n):                                   # key chunk j
        for r in range(n):                               # query shard r
            out, l = outs[r]
            dq_t, dk_t, dv_t = seq.shard_backward(
                port, cut(q, r), cut(k, j), cut(v, j), cut(do, r),
                rowsum(cut(do, r), out, port.heads), l, scale,
                seq.shard_tables(port, n, r, j, cuda),
                dq_dtype=torch.float32)
            assert dq_t.dtype == torch.float32
            dqs[r] += dq_t
            dks[:, j * L:(j + 1) * L] += dk_t
            dvs[:, j * L:(j + 1) * L] += dv_t
    torch.cuda.synchronize()
    tol = F32_TOL if dtype == torch.float32 else ATTN_BF16_TOL
    torch.testing.assert_close(torch.cat([o for o, _ in outs], 1),
                               y.float(), rtol=0, atol=tol)
    torch.testing.assert_close(torch.cat([l for _, l in outs], 2), lse,
                               rtol=0, atol=1e-5)
    for got, want in ((torch.cat(dqs, 1), dq.float()), (dks, dk),
                      (dvs, dv)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=tol * max(1.0,
                                                  want.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_kernels_store_zeros_for_empty_rows(cuda, dtype):
    """Gather shard 0 of 4: the key rows past its queries have no entry and
    get zero dk/dv; the ring pair (0, 3), above the diagonal, has no block
    at all: zeros and lse -inf forward, zero dq/dk/dv."""
    from blocksparse_tpu_torch.parallel import sequence as seq
    port, (q, k, v, do), scale, _, rowsum = _seq_case(cuda, dtype, 64, 8)
    L = q.shape[1] // 4
    tab = seq.shard_tables(port, 4, 0, None, cuda)
    y0, l0 = seq.shard_forward(port, q[:, :L], k, v, scale, tab)
    _, dk0, dv0 = seq.shard_backward(port, q[:, :L], k, v, do[:, :L],
                                     rowsum(do[:, :L], y0, port.heads), l0,
                                     scale, tab)
    torch.cuda.synchronize()
    assert not dk0[:, L:].any() and not dv0[:, L:].any()
    assert dk0[:, :L].abs().max() > 0
    pair = seq.shard_tables(port, 4, 0, 3, cuda)
    assert int(pair["row_ptr"].sum()) == 0
    o, l = seq.shard_forward(port, q[:, :L], k[:, 3 * L:], v[:, 3 * L:],
                             scale, pair)
    dq, dk, dv = seq.shard_backward(
        port, q[:, :L], k[:, 3 * L:], v[:, 3 * L:], do[:, :L],
        rowsum(do[:, :L], y0, port.heads), l0, scale, pair,
        dq_dtype=torch.float32)
    torch.cuda.synchronize()
    assert not o.any() and bool(torch.isneginf(l).all())
    assert not dq.any() and not dk.any() and not dv.any()


# ---------------- pipeline and expert parallelism in one process

@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_stages_on_the_card_match_the_unpipelined_step(cuda, S):
    """A small f32 LM (4 blocks) cut into S stages, driven on the kernels
    by ``run_stages``/``backprop_stages`` (``stage_forward`` and
    ``stage_backward`` in turn, 4 microbatches, activations handed over
    by tensor), the embedding and head outside as ``loss_pp`` has them:
    the loss and every gradient against the unpipelined loss's on the same
    card (f32 kernels at the microbatch's N: the same sums in other
    orders, 1e-4 of each gradient's largest entry)."""
    from blocksparse_tpu_torch.ops.transformer import softmax_cross_entropy
    from blocksparse_tpu_torch.parallel import microbatch, unmicrobatch
    from torch_one_process import backprop_stages, run_stages
    cfg = TransformerConfig(**dict(GRAPH_LM, n_layer=4, dtype="float32"))
    model = SparseTransformerLM(cfg, device=cuda)
    model.load_state_dict(params_from_jax(random_jax_params(model, 9),
                                          model))
    tokens = torch.randint(0, cfg.n_vocab, (4, cfg.ctx), device=cuda,
                           generator=_gen(cuda, 26))
    params = dict(model.named_parameters())
    loss = model.loss(tokens, tokens)
    ref = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    n = cfg.n_layer // S
    stages = [model.h[s * n:(s + 1) * n] for s in range(S)]
    x = model._embed(tokens, model.wpe[None, :cfg.ctx])
    xm = microbatch(x, 4)
    recs, ym, _ = run_stages(model._stage, stages, xm, with_aux=True)
    ym.requires_grad_()
    staged = softmax_cross_entropy(model._logits(unmicrobatch(ym)),
                                   tokens).mean()
    head = [model.wte, model.lnf_g, model.lnf_b]
    dym, *dhead = torch.autograd.grad(staged, [ym] + head)
    dx, stage_grads = backprop_stages(recs, stages, dym)
    dwte, dwpe = torch.autograd.grad(xm, [model.wte, model.wpe], dx)
    names = {id(p): k for k, p in params.items()}
    got = {names[id(p)]: gr for s in range(S)
           for p, gr in zip(stages[s].parameters(), stage_grads[s])}
    got.update(wte=dhead[0] + dwte, wpe=dwpe, lnf_g=dhead[1],
               lnf_b=dhead[2])
    assert abs(staged.item() - loss.item()) <= 1e-5 * abs(loss.item())
    assert set(got) == set(ref)
    for k, want in ref.items():
        err = (got[k] - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), k


@pytest.mark.cuda
@pytest.mark.parametrize("ep", [2, 4])
def test_moe_ep_shards_on_the_card_match_the_ep1_layer(cuda, ep):
    """The b32 MoE layer's ep shards in one process (``run_ep_shards`` of
    ``tests/torch_one_process.py``:
    each shard routes its own tokens, the all-to-all by slicing, the
    experts' f32 products at N = ep·C) against the ep 1 layer on each
    shard's tokens: y, aux and every gradient (f32 tokens: the same
    products at another N, 1e-5 of the largest entry)."""
    from blocksparse_tpu_torch.ops.moe import BlocksparseMoE
    from torch_one_process import run_ep_shards
    kw = dict(block_size=32, density=0.5, capacity_factor=1.25, k=1)
    one = BlocksparseMoE(8, 64, 128, **kw)
    moe = BlocksparseMoE(8, 64, 128, ep=ep, **kw)
    params = one.init(_gen(cuda, 27), device=cuda)
    x = torch.randn((1024, 64), device=cuda, generator=_gen(cuda, 28))
    dy = torch.randn((1024, 64), device=cuda, generator=_gen(cuda, 29))
    runs = []
    for fn in (lambda p, xs: [one(p, t) for t in xs],
               lambda p, xs: run_ep_shards(moe, p, xs)):
        p = {k: t.clone().requires_grad_() for k, t in params.items()}
        xs = [t.clone().requires_grad_() for t in x.chunk(ep)]
        outs = fn(p, xs)
        loss = sum((y * d).sum() + a for (y, a), d in zip(outs, dy.chunk(ep)))
        runs.append([t for y, a in outs for t in (y, a)] + list(
            torch.autograd.grad(loss, xs + list(p.values()))))
    for got, want in zip(*runs[::-1]):
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,bsize", [("auto", 32), ("grouped", 16),
                                        ("window", 32)])
def test_packed_op_matches_its_canonical_op(cuda, mode, bsize, dtype):
    """``w_layout="fprop_packed"`` on the card: the store's gather feeds
    the canonical op's kernels, so y and dx equal the canonical op's bit
    for bit, dW its dW repacked bit for bit, the padding zero; the unpack
    and the repack are exact, and the launches are the canonical op's."""
    layout = random_layout(16, 12, 0.35, seed=bsize)
    can = BlocksparseMatMul(layout, block_size=bsize, feature_axis=0,
                            mode=mode)
    pk = BlocksparseMatMul(layout, block_size=bsize, feature_axis=0,
                           mode=mode, w_layout="fprop_packed")
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(can.i_shape(200), generator=g, device=cuda).to(dtype)
    e = torch.randn(can.o_shape(200), generator=g, device=cuda).to(dtype)
    w = (torch.rand(can.w_shape, generator=g, device=cuda) - 0.5).to(dtype)
    wp = pk.pack_weights(w)
    assert wp.shape == pk.w_shape
    assert torch.equal(pk.unpack_weights(wp), w)
    assert torch.equal(wp.cpu(), torch.from_numpy(
        pk.pack_weights(w.float().cpu().numpy())).to(dtype))

    def run(op, weights):
        xi, wi = x.clone().requires_grad_(), weights.clone().requires_grad_()
        y = op(xi, wi)
        y.backward(e)
        return y.detach(), xi.grad, wi.grad
    def counts():
        return np.array([getattr(bsmm_kernels, n).launches for n in (
            "bsmm_fprop", "bsmm_bprop", "bsmm_updat", "bsmm_updat_reduce",
            "bsmm_fine", "bsmm_window", "bsmm_merge", "bsmm_split")])
    before = counts()
    y0, dx0, dw0 = run(can, w)
    mid = counts()
    y1, dx1, dw1 = run(pk, wp)
    torch.cuda.synchronize()
    assert (counts() - mid == mid - before).all() and (mid > before).any()
    assert torch.equal(y1, y0) and torch.equal(dx1, dx0)
    assert torch.equal(dw1, pk.pack_weights(dw0))
    assert torch.equal(pk.pack_weights(pk.unpack_weights(dw1)), dw1)
