"""The port's kernel modules against the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through the reference
(the Pallas kernel in interpret mode, its jnp twin, its jnp oracle) and
through the port's plain PyTorch version — which is what the port's kernel
wrapper runs for a tensor that lies on the CPU.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 at f32 (sums taken in another order),
2e-2 at bf16 (one rounding of O(1) outputs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import paged_attention as jpa
from repro.kernels import ref as jref
from repro_torch import runtime
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

TOL_F32, TOL_BF16 = 2e-5, 2e-2


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got.float().numpy() - want)))


def _bf16(a: np.ndarray):
    """The same bf16 values on both sides (rounded once, by torch)."""
    t = torch.tensor(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# K1: ragged paged-attention decode
# ---------------------------------------------------------------------------

def _paged_case(seed, S, H, Kv, hd, page_size, max_pages, lengths):
    rng = np.random.default_rng(seed)
    n_blocks = S * max_pages
    q = rng.standard_normal((S, H, hd)).astype(np.float32)
    pool = rng.standard_normal(
        (n_blocks + 1, page_size, 2 * Kv, hd)).astype(np.float32)
    perm = rng.permutation(n_blocks)
    tables = np.full((S, max_pages), n_blocks, np.int32)    # trash-padded
    k = 0
    for s, n in enumerate(lengths):
        need = -(-n // page_size)
        tables[s, :need] = perm[k:k + need]
        k += need
    return q, pool, tables, np.asarray(lengths, np.int32)


PAGED_GRID = [
    (4, 4, 2, 16, 8, 6, (1, 13, 40, 48)),     # ragged incl. page-aligned
    (3, 8, 8, 32, 4, 8, (32, 7, 19)),         # MHA (rep=1), odd tails
    (2, 2, 1, 64, 16, 2, (16, 31)),           # single kv head, wide hd
]


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("S,H,Kv,hd,ps,max_pages,lengths", PAGED_GRID)
def test_paged_plain_matches_reference(depth, S, H, Kv, hd, ps, max_pages,
                                       lengths):
    arrs = _paged_case(17, S, H, Kv, hd, ps, max_pages, lengths)
    jq, jpool, jtbl, jlen = (jnp.asarray(a) for a in arrs)
    tq, tpool, ttbl, tlen = (torch.tensor(a) for a in arrs)
    got = tpa.paged_attention_torch(tq, tpool, ttbl, tlen,
                                    buffer_depth=depth)
    assert got.shape == (S, H, hd) and got.dtype == torch.float32
    assert _err(got, jpa.paged_attention_fwd(
        jq, jpool, jtbl, jlen, buffer_depth=depth, interpret=True)) < TOL_F32
    assert _err(got, jpa.paged_attention_xla(
        jq, jpool, jtbl, jlen, buffer_depth=depth)) < TOL_F32
    assert _err(got, jref.paged_attention_ref(jq, jpool, jtbl, jlen)) \
        < TOL_F32
    # the port's own oracle agrees with the reference's
    assert _err(tref.paged_attention_ref(tq, tpool, ttbl, tlen),
                jref.paged_attention_ref(jq, jpool, jtbl, jlen)) < TOL_F32


def test_paged_plain_bf16_matches_reference():
    q, pool, tbl, lens = _paged_case(19, *PAGED_GRID[0])
    (tq, jq), (tpool, jpool) = _bf16(q), _bf16(pool)
    got = tpa.paged_attention_torch(tq, tpool, torch.tensor(tbl),
                                    torch.tensor(lens))
    assert got.dtype == torch.bfloat16
    want = jpa.paged_attention_fwd(jq, jpool, jnp.asarray(tbl),
                                   jnp.asarray(lens), interpret=True)
    assert _err(got, want) < TOL_BF16


def test_paged_plain_ignores_trash_and_pad_positions():
    """Only the first ``length`` positions of a sequence's own pages may
    contribute: corrupting the trash page, the unowned pages and the
    owned-but-past-length tail must not move the output at all."""
    lengths = (5, 17, 26)
    q, pool, tbl, lens = _paged_case(23, 3, 4, 2, 16, 8, 4, lengths)
    args = (torch.tensor(q), torch.tensor(tbl), torch.tensor(lens))
    base = tpa.paged_attention_torch(args[0], torch.tensor(pool), *args[1:])
    owned = set()
    for s, n in enumerate(lengths):
        owned.update(tbl[s, :-(-n // 8)].tolist())
    poisoned = pool.copy()
    for p in range(poisoned.shape[0]):
        if p not in owned:
            poisoned[p] = 1e6            # trash + unowned pages
    for s, n in enumerate(lengths):
        last = tbl[s, (n - 1) // 8]
        poisoned[last, n % 8 or 8:] = 1e6   # past-length tail of last page
    got = tpa.paged_attention_torch(args[0], torch.tensor(poisoned),
                                    *args[1:])
    assert float((got - base).abs().max()) == 0.0
    # and the reference kernel gives the same answer on the poisoned pool
    want = jpa.paged_attention_fwd(jnp.asarray(q), jnp.asarray(poisoned),
                                   jnp.asarray(tbl), jnp.asarray(lens),
                                   interpret=True)
    assert _err(got, want) < TOL_F32


def test_paged_all_trash_row_length_one():
    """A free slot decodes against an all-trash table row at length 1:
    the output is that one position's V row, finite."""
    q, pool, tbl, lens = _paged_case(31, 2, 4, 2, 16, 8, 3, (1, 9))
    tbl[0, :] = pool.shape[0] - 1
    got = tpa.paged_attention_torch(torch.tensor(q), torch.tensor(pool),
                                    torch.tensor(tbl), torch.tensor(lens))
    v_row = pool[-1, 0].reshape(2, 2, 16)[:, 1]           # (Kv, hd)
    want = np.repeat(v_row, 2, axis=0)                    # rep = 2
    assert np.allclose(got[0].numpy(), want, atol=1e-6)


@pytest.mark.parametrize("bad", [
    dict(buffer_depth=0),
    dict(q_shape=(2, 3, 16)),            # H % Kv != 0
])
def test_paged_rejects_bad_arguments(bad):
    q, pool, tbl, lens = _paged_case(3, 2, 4, 2, 16, 8, 3, (4, 9))
    if "q_shape" in bad:
        q = np.zeros(bad["q_shape"], np.float32)
    with pytest.raises(ValueError):
        tpa.paged_attention_fwd(torch.tensor(q), torch.tensor(pool),
                                torch.tensor(tbl), torch.tensor(lens),
                                buffer_depth=bad.get("buffer_depth", 2))


# ---------------------------------------------------------------------------
# K1 on the card: the split kernel's design, emulated in plain torch
# ---------------------------------------------------------------------------

def _split_design(q, pool, tables, lengths, *, depth=2, span=None):
    """The split kernel's arithmetic in plain torch at f32: the sequence
    cut into runs of ``span`` pages (``_split_plan``'s unless given), each
    split's online softmax over its ring tiles (``_ring_plan``) reading
    only positions before the length, its partial ``(m, l, acc)``, and the
    live splits merged in split order with ``exp(m_i - m)`` weights."""
    S, H, hd = q.shape
    _, ps, kv2, _ = pool.shape
    Kv, mp = kv2 // 2, tables.shape[1]
    rep, item = H // Kv, q.element_size()
    if span is None:
        span, n_split = tpa._split_plan(S, Kv, mp, ps, hd, item)
    else:
        n_split = -(-mp // span)
    tile, _ = tpa._ring_plan(ps, hd, item, depth, span)
    qh = q.float().reshape(S, Kv, rep, hd) * hd ** -0.5
    out = torch.zeros((S, Kv, rep, hd))
    for s in range(S):
        length = max(0, min(int(lengths[s]), mp * ps))
        n_pages = -(-length // ps)
        parts = []
        for i in range(n_split):
            if i * span >= n_pages:
                break                        # empty: writes nothing
            m = torch.full((Kv, rep), -1e30)
            l = torch.zeros((Kv, rep))
            acc = torch.zeros((Kv, rep, hd))
            for j in range(i * span, min((i + 1) * span, n_pages)):
                for off in range(0, ps, tile):
                    rows = min(tile, ps - off, length - j * ps - off)
                    if rows <= 0:
                        break
                    kv = pool[int(tables[s, j]), off:off + rows].float()
                    kv = kv.reshape(rows, Kv, 2, hd)
                    sc = torch.einsum("grh,tgh->grt", qh[s], kv[:, :, 0])
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.exp(sc - m_new[..., None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "grt,tgh->grh", p, kv[:, :, 1])
                    m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        lsum, a = torch.zeros((Kv, rep)), torch.zeros((Kv, rep, hd))
        for m, l, acc in parts:                       # in split order
            w = torch.exp(m - mx)
            lsum = lsum + l * w
            a = a + acc * w[..., None]
        out[s] = a / lsum.clamp_min(1e-30)[..., None]
    return out.reshape(S, H, hd).to(q.dtype)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("S,H,Kv,hd,ps,max_pages,lengths", PAGED_GRID)
def test_paged_split_design_matches_reference(depth, S, H, Kv, hd, ps,
                                              max_pages, lengths):
    arrs = _paged_case(17, S, H, Kv, hd, ps, max_pages, lengths)
    jq, jpool, jtbl, jlen = (jnp.asarray(a) for a in arrs)
    got = _split_design(*(torch.tensor(a) for a in arrs), depth=depth)
    assert _err(got, jpa.paged_attention_fwd(
        jq, jpool, jtbl, jlen, buffer_depth=depth, interpret=True)) < TOL_F32
    assert _err(got, jpa.paged_attention_xla(
        jq, jpool, jtbl, jlen, buffer_depth=depth)) < TOL_F32


@pytest.mark.parametrize("span", [2, 3])     # 3 does not divide 7 pages
@pytest.mark.parametrize("at", ["boundary", "boundary+1"])
def test_paged_split_design_at_split_boundaries(span, at):
    """Lengths at and one past the end of a split (and of two), a split
    span that does not divide ``max_pages``, and a length of 1."""
    ps, mp = 4, 7
    edge = span * ps + (1 if at == "boundary+1" else 0)
    lengths = (edge, edge + span * ps, 1, mp * ps)
    arrs = _paged_case(41, 4, 4, 2, 16, ps, mp, lengths)
    jq, jpool, jtbl, jlen = (jnp.asarray(a) for a in arrs)
    got = _split_design(*(torch.tensor(a) for a in arrs), span=span)
    assert _err(got, jpa.paged_attention_fwd(
        jq, jpool, jtbl, jlen, interpret=True)) < TOL_F32
    assert _err(got, jpa.paged_attention_xla(jq, jpool, jtbl, jlen)) \
        < TOL_F32


def test_paged_split_design_clamps_a_length_past_the_table():
    """A length past ``max_pages * page_size`` attends over every page of
    the row, as the reference's oracle and its jnp twin (which mask by
    position; the twin at depth 1, since a depth that does not divide
    ``max_pages`` pads the row with trash pages that such a length would
    reach) do."""
    ps, mp = 4, 7
    arrs = _paged_case(43, 3, 4, 2, 16, ps, mp, (mp * ps, 9, 2))
    arrs[3][0] = mp * ps + 13
    jq, jpool, jtbl, jlen = (jnp.asarray(a) for a in arrs)
    for span in (None, 3):
        got = _split_design(*(torch.tensor(a) for a in arrs), span=span)
        assert _err(got, jpa.paged_attention_xla(
            jq, jpool, jtbl, jlen, buffer_depth=1)) < TOL_F32
        assert _err(got, jref.paged_attention_ref(jq, jpool, jtbl, jlen)) \
            < TOL_F32


def test_paged_split_design_all_trash_row_length_one():
    q, pool, tbl, lens = _paged_case(31, 2, 4, 2, 16, 8, 3, (1, 9))
    tbl[0, :] = pool.shape[0] - 1
    pool[-1, 1:] = 1e6          # the trash page past position 0
    got = _split_design(torch.tensor(q), torch.tensor(pool),
                        torch.tensor(tbl), torch.tensor(lens), span=1)
    v_row = pool[-1, 0].reshape(2, 2, 16)[:, 1]           # (Kv, hd)
    assert np.allclose(got[0].numpy(), np.repeat(v_row, 2, axis=0),
                       atol=1e-6)
    want = jpa.paged_attention_xla(*(jnp.asarray(a)
                                     for a in (q, pool, tbl, lens)))
    assert _err(got, want) < TOL_F32


PLAN_CASES = [  # S, Kv, max_pages, page_size, hd, itemsize
    (16, 16, 128, 16, 128, 2),    # the serve path's decode tick
    (16, 16, 128, 16, 128, 4),
    (1, 8, 128, 16, 128, 2),      # one sequence: spans shrink
    (3, 2, 7, 4, 16, 4), (4, 2, 6, 8, 16, 2), (2, 1, 2, 16, 64, 4),
    (64, 8, 2048, 1, 32, 2),      # one-position pages
    (2, 1, 3, 256, 128, 4),       # pages larger than the ring
    (1, 1, 1, 1024, 16, 4), (5, 3, 1000, 7, 64, 2),
]


@pytest.mark.parametrize("S,Kv,max_pages,ps,hd,item", PLAN_CASES)
def test_split_plan_covers_every_page_once(S, Kv, max_pages, ps, hd, item):
    span, n_split = tpa._split_plan(S, Kv, max_pages, ps, hd, item)
    assert 1 <= span <= max_pages and n_split == -(-max_pages // span)
    owner = [[i for i in range(n_split)
              if i * span <= j < min((i + 1) * span, max_pages)]
             for j in range(max_pages)]
    assert all(len(o) == 1 for o in owner)
    assert span * ps * 2 * hd * item <= max(tpa.SPLIT_BYTES,
                                            ps * 2 * hd * item)
    # ... and the ring the kernel keeps for it fits in a block
    for depth in (1, 2, 4, 16):
        tile, slots = tpa._ring_plan(ps, hd, item, depth, span)
        assert 1 <= tile <= ps and 1 <= slots <= min(depth, tpa.MAX_SLOTS)
        assert slots * tile * 2 * hd * item + 4 * span + 16 \
            <= tpa.SMEM_BYTES
        if tile * 2 * hd * item * depth <= 96 * 1024 and depth <= 8:
            assert tile == ps and slots == min(depth, span)


def test_split_plan_of_the_serve_path():
    """At the decode tick's sizes a split is 8 pages (128 positions):
    the chip run's lengths (1 ... 2048, 14,565 in all) and the traced
    tick's (513, 1001, 129, 78 four times) give the grid over two waves
    of live blocks on 132 SMs; the ring holds buffer_depth whole pages."""
    assert tpa._split_plan(16, 16, 128, 16, 128, 2) == (8, 16)
    rng = np.random.default_rng(5)
    lengths = [int(x) for x in rng.integers(129, 2049, size=16)]
    lengths[0], lengths[1] = 2048, 1
    assert sum(lengths) == 14565
    for lens in (lengths, (513, 1001, 129, 78) * 4):
        live = sum(-(-(-(-n // 16)) // 8) for n in lens) * 16
        assert 2 * 132 <= live <= 16 * 16 * 16
    for depth in (1, 2, 4):
        assert tpa._ring_plan(16, 128, 2, depth, 8) == (16, depth)
    # a page of 256 f32 positions at hd 128 (256 KiB) is cut into tiles
    tile, slots = tpa._ring_plan(256, 128, 4, 2, 1)
    assert tile < 256 and slots == 1


def test_split_plan_reads_only_static_sizes():
    """The plan is a function of integer sizes alone, and the wrapper
    reads nothing back from the device (no ``.item()``, ``.cpu()``,
    ``.tolist()`` or ``.numpy()``): a decode tick never synchronises."""
    import inspect
    params = inspect.signature(tpa._split_plan).parameters
    assert list(params) == ["S", "Kv", "max_pages", "page_size", "hd",
                            "itemsize"]
    assert all(p.annotation in (int, "int") for p in params.values())
    src = inspect.getsource(tpa.paged_attention_fwd)
    for call in (".item(", ".cpu(", ".tolist(", ".numpy(", "int(lengths"):
        assert call not in src, call


# ---------------------------------------------------------------------------
# K2: FlashAttention-2 forward
# ---------------------------------------------------------------------------

def _flash_case(seed, B, S, H, Kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, Kv, hd)).astype(np.float32),
            rng.standard_normal((B, S, Kv, hd)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,Kv,hd", [
    (2, 128, 4, 2, 64), (1, 256, 4, 4, 32), (2, 64, 8, 2, 16),
    (1, 128, 2, 1, 128),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_plain_matches_reference(B, S, H, Kv, hd, causal, window):
    arrs = _flash_case(42, B, S, H, Kv, hd)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    tq, tk, tv = (torch.tensor(a) for a in arrs)
    got = tfa.flash_attention_torch(tq, tk, tv, causal=causal, window=window,
                                    block_k=64)
    assert got.shape == (B, S, H, hd)
    assert _err(got, jfa.flash_attention_fwd(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)) < TOL_F32
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert _err(got, want) < TOL_F32
    assert _err(tref.flash_attention_ref(tq, tk, tv, causal=causal,
                                         window=window), want) < TOL_F32


@pytest.mark.parametrize("S,block_q,block_k,causal,window", [
    (130, 64, 64, True, 0),    # ragged tail past the last full block
    (100, 32, 64, True, 0),    # blocks of different sizes, both ragged
    (77, 32, 32, False, 0),    # non-causal: pad keys masked only by kpos<S
    (130, 64, 64, True, 48),   # sliding window across the ragged tail
])
def test_flash_plain_ragged_tail(S, block_q, block_k, causal, window):
    arrs = _flash_case(21, 2, S, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    got = tfa.flash_attention_torch(*(torch.tensor(a) for a in arrs),
                                    causal=causal, window=window,
                                    block_k=block_k)
    assert got.shape == (2, S, 4, 16)
    assert _err(got, jfa.flash_attention_fwd(
        jq, jk, jv, causal=causal, window=window, block_q=block_q,
        block_k=block_k, interpret=True)) < TOL_F32
    assert _err(got, jref.flash_attention_ref(
        jq, jk, jv, causal=causal, window=window)) < TOL_F32


@pytest.mark.parametrize("S", [8, 16, 1000])
def test_flash_plain_prompt_lengths_of_the_serve_path(S):
    """Prefill is batch-1 at the exact prompt length: any S, default
    block."""
    arrs = _flash_case(5, 1, S, 4, 4, 16)
    got = tfa.flash_attention_torch(*(torch.tensor(a) for a in arrs))
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs))
    assert _err(got, want) < TOL_F32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtypes(dtype):
    q, k, v = _flash_case(1, 1, 128, 4, 2, 32)
    if dtype == "bfloat16":
        (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(k), _bf16(v)
    else:
        tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = tfa.flash_attention_torch(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    want = jfa.flash_attention_fwd(jq, jk, jv, block_q=64, block_k=64,
                                   interpret=True)
    assert _err(got, want) < (TOL_F32 if dtype == "float32" else TOL_BF16)


def _flash_bf16_design(q, k, v, *, causal, window, block_k=64,
                       sm_scale=None):
    """The bf16 kernel's arithmetic, written out in torch: bf16 q, k, v;
    f32 products; sm_scale applied to the f32 scores (q is never scaled
    before rounding); an online softmax over 64-key tiles whose
    probabilities are rounded to bf16 for the second product, while the
    row sum is taken from the f32 probabilities."""
    B, S, H, hd = q.shape
    sm_scale = hd ** -0.5 if sm_scale is None else sm_scale
    Kv = k.shape[2]
    qh = q.float().reshape(B, S, Kv, H // Kv, hd)
    acc = torch.zeros((B, Kv, H // Kv, S, hd))
    m = torch.full((B, Kv, H // Kv, S), -1e30)
    l = torch.zeros((B, Kv, H // Kv, S))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        kpos = torch.arange(k0, min(k0 + block_k, S))[None, :]
        mask = torch.ones((S, kpos.shape[1]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s = torch.einsum("bqgrh,bsgh->bgrqs", qh,
                         k[:, k0:k0 + block_k].float()) * sm_scale
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])            # masked: exactly 0
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrqs,bsgh->bgrqh", p.to(torch.bfloat16).float(),
            v[:, k0:k0 + block_k].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(torch.bfloat16)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_bf16_design_rounding_fits_the_kernel_tolerance(causal, window):
    """At the serve path's head size and longest prompt, the roundings the
    bf16 kernel adds (P to bf16 before P V, on top of bf16 inputs and a
    bf16 output) stay within TOL_BF16 = 2e-2 (one bf16 rounding of O(1)
    outputs) of the reference's full-softmax oracle: the tolerance
    chip_smoke.py holds the kernel to on the card."""
    q, k, v = _flash_case(3, 1, 1024, 2, 2, 128)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(k), _bf16(v)
    got = _flash_bf16_design(tq, tk, tv, causal=causal, window=window)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _err(got, want) < TOL_BF16


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0), (False, 48)])
@pytest.mark.parametrize("H", [8, 2])                       # rep 4, rep 1
def test_flash_plain_hd120_matches_reference(H, causal, window):
    """Head dim 120 (H2O-Danube3-4B), which the kernel runs on tiles
    padded to 128 columns: the plain version against the reference's
    Pallas kernel (interpret mode) and its oracle at a ragged S of 130."""
    arrs = _flash_case(120, 1, 130, H, 2, 120)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    got = tfa.flash_attention_torch(*(torch.tensor(a) for a in arrs),
                                    causal=causal, window=window)
    assert got.shape == (1, 130, H, 120)
    assert _err(got, jfa.flash_attention_fwd(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)) < TOL_F32
    assert _err(got, jref.flash_attention_ref(
        jq, jk, jv, causal=causal, window=window)) < TOL_F32
    assert 120 in tfa.HEAD_DIMS


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_flash_hd120_padded_design_fits_the_kernel_tolerance(causal, window):
    """The hd-120 kernel's design, written out: q, k and v carried on tiles
    of 128 columns whose last 8 are zero (as the kernel's shared-memory
    tiles), the bf16 arithmetic of ``_flash_bf16_design`` on them with
    sm_scale = 120 ** -0.5, and the first 120 output columns kept.  The
    pad columns come out exactly zero, and the result stays within
    TOL_BF16 of the reference's oracle at hd 120 — while the scale of the
    padded width, 128 ** -0.5, would not."""
    q, k, v = _flash_case(7, 1, 1024, 8, 2, 120)
    (tq, jq), (tk, jk), (tv, jv) = _bf16(q), _bf16(k), _bf16(v)
    pad = (lambda t: torch.nn.functional.pad(t, (0, 8)))   # noqa: E731
    out = _flash_bf16_design(pad(tq), pad(tk), pad(tv), causal=causal,
                             window=window, sm_scale=120 ** -0.5)
    assert out.shape == (1, 1024, 8, 128)
    assert not out[..., 120:].any()
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    assert _err(out[..., :120], want) < TOL_BF16
    trap = _flash_bf16_design(pad(tq), pad(tk), pad(tv), causal=causal,
                              window=window)              # 128 ** -0.5
    assert _err(trap[..., :120], want) > TOL_BF16


@pytest.mark.parametrize("S,causal,window", [(4608, True, 4096),
                                             (4608, False, 4096),
                                             (4064, True, 64)])
def test_flash_hd120_bf16_bound_takes_the_design_and_rejects_a_lost_tile(
        S, causal, window):
    """``chip_smoke.py`` holds K2's bf16 outputs element by element
    (``bf16_excess``: BF16_ULPS spacings of the plain output plus
    ROW_SHARE of its row's RMS), where the window binds: the last 512
    rows at S = 4608, window 4096, and every block past the first at
    window 64.  The padded hd-120 design uses under half of that bound,
    while the plain version with the window's first key tile dropped
    (``window_edge_fault``: K2's key-block range one tile short) exceeds
    it."""
    import chip_smoke
    q, k, v = (_bf16(a)[0] for a in _flash_case(9, 1, S, 4, 1, 120))
    plain = tfa.flash_attention_torch(q, k, v, causal=causal, window=window)
    pad = (lambda t: torch.nn.functional.pad(t, (0, 8)))   # noqa: E731
    design = _flash_bf16_design(pad(q), pad(k), pad(v), causal=causal,
                                window=window, sm_scale=120 ** -0.5)
    assert chip_smoke.bf16_excess(design[..., :120], plain) < 0.5
    bad = chip_smoke.window_edge_fault(q, k, v, causal=causal, window=window)
    assert bad.dtype == torch.bfloat16 and bad.shape == plain.shape
    assert chip_smoke.bf16_excess(bad, plain) > 1


def test_flash_rejects_bad_arguments():
    q, k, v = (torch.tensor(a) for a in _flash_case(2, 1, 16, 4, 2, 16))
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k[:, :8], v[:, :8])        # S != Sk
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k, v, window=-1)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q[:, :, :3], k, v)            # H % Kv


# ---------------------------------------------------------------------------
# wrappers and dispatch on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_for_cpu_tensors(monkeypatch):
    """A kernel wrapper given a CPU tensor runs the plain version — and
    only because the tensor lies on the CPU: nothing is built, nothing is
    launched, no launch is counted."""
    from repro_torch.kernels import _build
    seen = []
    monkeypatch.setattr(
        tpa, "paged_attention_torch",
        lambda *a, **kw: seen.append(("paged", kw["buffer_depth"]))
        or "paged-plain")
    monkeypatch.setattr(
        tfa, "flash_attention_torch",
        lambda *a, **kw: seen.append(("flash", kw["causal"], kw["window"]))
        or "flash-plain")
    monkeypatch.setattr(_build, "lib", lambda *a, **kw: pytest.fail(
        "the CUDA library was asked for on a CPU tensor"))
    tops.reset_launch_counts()
    q, pool, tbl, lens = (torch.tensor(a) for a in
                          _paged_case(3, 2, 4, 2, 16, 8, 3, (4, 9)))
    assert tpa.paged_attention_fwd(q, pool, tbl, lens,
                                   buffer_depth=3) == "paged-plain"
    fq, fk, fv = (torch.tensor(a) for a in _flash_case(2, 1, 16, 4, 2, 16))
    assert tfa.flash_attention_fwd(fq, fk, fv, causal=False,
                                   window=4) == "flash-plain"
    assert seen == [("paged", 3), ("flash", False, 4)]
    assert tops.launch_counts() == {"flash_attention": 0,
                                    "paged_attention": 0, "rwkv6_scan": 0,
                                    "quantize_int8": 0, "dequantize_int8": 0}
    assert _build._LIB is None


def test_ops_dispatch_follows_the_policy(monkeypatch):
    calls = []
    monkeypatch.setattr(tpa, "paged_attention_fwd",
                        lambda *a, **kw: calls.append(("k1-wrapper", kw)))
    monkeypatch.setattr(tpa, "paged_attention_torch",
                        lambda *a, **kw: calls.append(("k1-plain", kw)))
    monkeypatch.setattr(tfa, "flash_attention_fwd",
                        lambda *a, **kw: calls.append(("k2-wrapper", kw)))
    monkeypatch.setattr(tfa, "flash_attention_torch",
                        lambda *a, **kw: calls.append(("k2-plain", kw)))
    assert runtime.policy()["attention_impl"] == "kernel"
    assert runtime.policy()["paged_attention_impl"] == "kernel"
    tops.paged_attention(1, 2, 3, 4)
    tops.flash_attention(1, 2, 3, causal=True, window=8)
    with runtime.use_policy(paged_attention_impl="torch",
                            attention_impl="torch", paged_buffer_depth=3):
        tops.paged_attention(1, 2, 3, 4)
        tops.paged_attention(1, 2, 3, 4, buffer_depth=1)
        tops.flash_attention(1, 2, 3)
    assert [c[0] for c in calls] == ["k1-wrapper", "k2-wrapper", "k1-plain",
                                     "k1-plain", "k2-plain"]
    assert calls[0][1] == {"buffer_depth": 2}
    assert calls[1][1] == {"causal": True, "window": 8}
    assert calls[2][1] == {"buffer_depth": 3}
    assert calls[3][1] == {"buffer_depth": 1}
    with runtime.use_policy(attention_impl="auto"):
        with pytest.raises(ValueError, match="attention_impl"):
            tops.flash_attention(1, 2, 3)


def test_build_signatures_cover_every_c_entry_point():
    """Every ``extern "C"`` function of the sources has its argtypes
    declared, with as many entries as the C function has parameters."""
    import re

    from repro_torch.kernels import _build
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\s*\((.*?)\)\s*\{', text,
                             re.S):
            found[m.group(1)] = len(m.group(2).split(","))
    assert set(found) == set(_build.SIGNATURES)
    for name, n in found.items():
        assert len(_build.SIGNATURES[name]) == n, name


def _grad_case(kernel):
    """A kernel's call on small CPU inputs, the first one requiring grad."""
    from repro_torch.kernels import quant as tq
    from repro_torch.kernels import rwkv6_scan as trs
    rng = np.random.default_rng(9)
    if kernel == "paged":
        q, pool, tbl, lens = (torch.tensor(a) for a in
                              _paged_case(3, 2, 4, 2, 16, 8, 3, (4, 9)))
        return lambda: tpa.paged_attention_fwd(q.requires_grad_(), pool, tbl,
                                               lens)
    if kernel == "flash":
        fq, fk, fv = (torch.tensor(a) for a in _flash_case(2, 1, 16, 4, 2, 16))
        return lambda: tfa.flash_attention_fwd(fq, fk.requires_grad_(), fv)
    if kernel == "rwkv":
        r, k, v = (torch.tensor(rng.standard_normal((1, 16, 2, 16)),
                                dtype=torch.float32) for _ in range(3))
        w = torch.full((1, 16, 2, 16), 0.9)
        u = torch.zeros((2, 16))
        return lambda: trs.rwkv6_scan_fwd(r, k, v.requires_grad_(), w, u,
                                          chunk=16)
    x = torch.tensor(rng.standard_normal((4, 32)), dtype=torch.float32)
    if kernel == "quant":
        return lambda: tq.quantize_int8(x.requires_grad_())
    q, s = tq.quantize_int8(x)
    return lambda: tq.dequantize_int8(q, s.requires_grad_())


@pytest.mark.parametrize("kernel", ["paged", "flash", "rwkv", "quant",
                                    "dequant"])
def test_kernel_wrappers_refuse_autograd(kernel):
    """The kernels have no backward: under grad mode, with an input that
    requires grad, each wrapper raises on every device (here: before its
    plain version runs) instead of returning an output without a
    ``grad_fn``; under ``no_grad`` it runs."""
    call = _grad_case(kernel)
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        out = call()
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is None and torch.isfinite(out.float()).all()
