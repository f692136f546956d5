"""Parity of avr_torch's hash-grid encode and table-gradient scatter with
the JAX package, on the CPU.

Here the port's wrappers take their plain versions (CPU tensors); JAX
takes its XLA scatter (``impl="xla"``, no one-hot levels, no split level
groups off the TPU). The CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.config import EncodingConfig
from avr_tpu.models import hashgrid as jhg
from avr_tpu.ops import hash_scatter as jhs

from chip_smoke import boundary_streams

from avr_torch.config import EncodingConfig as TEncodingConfig
from avr_torch.models import hashgrid as thg
from avr_torch.ops import hash_scatter as ths
from avr_torch.ops import hashgrid_encode as tenc

torch.set_num_threads(2)

# Kernel A's layout as ``hash_scatter.kernel_layout`` reads it on the card:
# stream rows per block, and the slab's 40 KB in rows of F floats.
CHUNK_ROWS = 2048


def _slab_rows(F):
    return 40960 // (4 * F)

INTERPS = ["trilinear", "simplex", "hybridc:2", "hybrid:1", "levels:tsts"]


def _cfgs(interp, **kw):
    base = dict(
        n_levels=4, n_features_per_level=2, log2_hashmap_size=8,
        base_resolution=4, per_level_scale=1.6, interpolation=interp,
    )
    base.update(kw)
    return EncodingConfig(**base), TEncodingConfig(**base)


def _groups(jst):
    """JAX statics per same-mode level group (the whole static if pure)."""
    return jhg._hybrid_groups(jst) or [jst]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-30)


def _scatter_stream(kind, F):
    """(idx, upd, n_rows) of one stream kind at a small size: ``collide``
    (every row collides), kernel A's boundary streams
    (``chip_smoke.boundary_streams``, 3 chunks), and a small grid's
    level-major corner stream as the encode gives it, in order and
    permuted."""
    rng = np.random.default_rng(0)
    if kind == "collide":
        M, E = 4096, 333  # ~12 updates per row
        return rng.integers(0, E, M).astype(np.int32), rng.normal(size=(M, F)).astype(np.float32), E
    if kind.startswith("corners"):
        _, tc = _cfgs("hybridc:2", n_levels=6)
        ts = thg.build_static(tc)
        x = torch.from_numpy(rng.uniform(0, 1, (512, 3)).astype(np.float32))
        idx = tenc.corners_reference(ts.levels, x)[0].numpy()
        if kind == "corners_permuted":
            idx = rng.permutation(idx)
        return idx, rng.normal(size=(idx.shape[0], F)).astype(np.float32), ts.padded_entries
    return boundary_streams(F, CHUNK_ROWS, _slab_rows(F), 3, seed=F, one_row_rows=65_536)[kind]


_BOUNDARY_KINDS = list(boundary_streams(1, CHUNK_ROWS, _slab_rows(1), 1, one_row_rows=8))
_SCATTER_CASES = [pytest.param("collide", F, id=str(F)) for F in (1, 2, 4)] + [
    pytest.param(kind, F, id=f"{kind}-F{F}")
    for kind in _BOUNDARY_KINDS + ["corners", "corners_permuted"]
    for F in (1, 2, 4)
]


@pytest.mark.parametrize("kind,F", _SCATTER_CASES)
def test_scatter_add_rows_matches_jax(kind, F):
    """The port's scatter (its plain version here) against JAX's XLA scatter
    on each stream kind. JAX wraps negative indices where the port drops
    them, so JAX gets the stream without them."""
    idx, upd, E = _scatter_stream(kind, F)
    keep = idx >= 0
    ref = np.asarray(jhs.scatter_add_rows(jnp.asarray(idx[keep]), jnp.asarray(upd[keep]), E, impl="xla"))
    got = ths.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd), E).numpy()
    assert got.shape == (E, F) and got.dtype == np.float32
    assert _rel(got, ref) < 1e-5  # fp32 sums in another order


@pytest.mark.parametrize("F", [1, 2, 4])
def test_boundary_streams_reach_their_boundaries(F):
    """Each boundary stream puts what its name says at kernel A's layout:
    chunk spans of exactly the slab and one row over, C distinct rows per
    chunk, runs of 33 / 1025 / C + 1, a ragged tail, rows out of range, and
    integer updates (exact sums)."""
    C, S = CHUNK_ROWS, _slab_rows(F)
    streams = boundary_streams(F, C, S, 4, one_row_rows=4096)
    for name, extra in (("span_slab", 0), ("span_slab_plus_1", 1)):
        ch = streams[name][0].reshape(-1, C)
        assert (ch.max(1) - ch.min(1) + 1 == S + extra).all()
    ch = streams["distinct_chunk"][0].reshape(-1, C)
    assert all(np.unique(c).size == C for c in ch) and (ch.max(1) - ch.min(1) >= S).all()
    for n in (33, 1025, C + 1):
        idx = streams[f"runs_{n}"][0]
        starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
        assert idx.size == 4 * C + 7 and (np.diff(starts) == n).all()
    assert streams["ragged"][0].size % C and streams["m_31"][0].size == 31
    assert streams["one_row"][0].size == 4096 and np.unique(streams["one_row"][0]).size == 1
    n_rows = streams["out_of_range"][2]
    bad = streams["out_of_range"][0]
    assert (bad < 0).any() and (bad >= n_rows).any()
    for idx, upd, _ in streams.values():
        assert upd.shape == (idx.size, F) and (upd == np.round(upd)).all()


def test_scatter_add_rows_drops_out_of_range_rows():
    """Rows indexed outside [0, n_rows) are dropped, as the CUDA kernel
    drops them. JAX's scatter drops the rows past the end as well (its
    negative indices wrap instead, so those are held to the kept rows only)."""
    rng = np.random.default_rng(1)
    M, E, F = 512, 40, 4
    idx = rng.integers(0, E, M).astype(np.int32)
    idx[::7] = E + rng.integers(0, 5, idx[::7].shape)
    idx[3::11] = -1 - rng.integers(0, 5, idx[3::11].shape)
    upd = rng.normal(size=(M, F)).astype(np.float32)
    got = ths.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd), E).numpy()
    keep = (idx >= 0) & (idx < E)
    kept = ths.scatter_add_rows(torch.from_numpy(idx[keep]), torch.from_numpy(upd[keep]), E).numpy()
    assert _rel(got, kept) < 1e-6
    past_end = idx >= 0
    ref = np.asarray(jhs.scatter_add_rows(jnp.asarray(idx[past_end]), jnp.asarray(upd[past_end]), E, impl="xla"))
    assert got.shape == (E, F)
    assert _rel(got, ref) < 1e-5


def test_scatter_add_rows_refuses_non_cpu_non_cuda():
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    upd = torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError):
        ths.scatter_add_rows(idx, upd, 16)


def _refused(case):
    idx = torch.zeros(64, dtype=torch.int32)
    upd = torch.zeros(64, 4)
    if case == "F3":
        return idx, torch.zeros(64, 3)
    if case == "misaligned_rows":
        return idx[:63], torch.zeros(64 * 4 + 1)[1:].view(64, 4)[:63]
    if case == "int64_idx":
        return idx.long(), upd
    if case == "float64_upd":
        return idx, upd.double()
    if case == "shapes":
        return idx[:32], upd
    if case == "non_contiguous":
        return idx, torch.zeros(4, 64).t()
    if case == "device_mix":
        return idx, upd.to("meta")
    raise KeyError(case)


@pytest.mark.parametrize(
    "case,error",
    [("F3", ValueError), ("misaligned_rows", ValueError), ("int64_idx", TypeError),
     ("float64_upd", TypeError), ("shapes", ValueError), ("non_contiguous", ValueError),
     ("device_mix", ValueError)],
)
def test_scatter_add_rows_refuses(case, error):
    """What the kernel does not take is refused on every device, the CPU too."""
    idx, upd = _refused(case)
    with pytest.raises(error):
        ths.scatter_add_rows(idx, upd, 16)


@pytest.mark.parametrize("interp", INTERPS)
def test_build_static_matches_jax(interp):
    jc, tc = _cfgs(interp, n_levels=4)
    js, ts = jhg.build_static(jc), thg.build_static(tc)
    for f in ("n_levels", "n_features", "resolutions", "offsets", "sizes", "hashed",
              "total_entries", "padded_entries", "interp"):
        assert getattr(js, f) == getattr(ts, f), f


@pytest.mark.parametrize("interp", INTERPS)
def test_level_groups_match_jax_hybrid_groups(interp):
    """The port's one-launch encode walks the same same-mode level groups
    that JAX's ``_hybrid_groups`` slices (never split off the TPU)."""
    jc, tc = _cfgs(interp)
    js, ts = jhg.build_static(jc), thg.build_static(tc)
    jg = []
    for g in _groups(js):
        lo = js.offsets.index(g.offsets[0])
        jg.append((lo, lo + g.n_levels, g.interp))
    tg = [(lo, hi, "simplex" if ts.levels[lo].K == 4 else "trilinear")
          for lo, hi in tenc.level_groups(ts.levels)]
    assert tg == jg


@pytest.mark.parametrize(
    "spec,n", [("hybridc", 5), ("hybridc:0", 4), ("hybridc:4", 4), ("hybrid:2", 4),
               ("levels:ssss", 4), ("levels:ttst", 4), ("Smoothstep", 3), ("", 3)]
)
def test_parse_interp_matches_jax(spec, n):
    assert thg._parse_interp(spec, n) == jhg._parse_interp(spec, n)


def _index_cases(rng):
    x = rng.uniform(-0.1, 1.1, (256, 3)).astype(np.float32)  # includes clamped points
    a = rng.uniform(0, 1, 64).astype(np.float32)
    b = rng.uniform(0, 1, 64).astype(np.float32)
    ties = np.concatenate([
        np.stack([a, a, b], -1), np.stack([a, b, a], -1), np.stack([b, a, a], -1),
        np.stack([a, a, a], -1),
        np.stack([np.zeros(8), np.ones(8), np.full(8, 0.5)], -1).astype(np.float32),
    ])
    return np.concatenate([x, ties]).astype(np.float32)


@pytest.mark.parametrize(
    "interp,kw",
    [
        ("trilinear", {}),
        ("simplex", {}),
        ("hybridc:2", {}),
        # every level hashed, coordinates up to 2^15: the prime products
        # wrap uint32 many times over
        ("hybridc:2", dict(base_resolution=4096, per_level_scale=2.0, log2_hashmap_size=12)),
        ("simplex", dict(base_resolution=4096, per_level_scale=2.0, log2_hashmap_size=12)),
    ],
    ids=["trilinear", "simplex", "hybridc2", "hashed-wrap-mixed", "hashed-wrap-simplex"],
)
def test_hash_indices_bit_equal(interp, kw):
    rng = np.random.default_rng(1)
    jc, tc = _cfgs(interp, **kw)
    js, ts = jhg.build_static(jc), thg.build_static(tc)
    x = _index_cases(rng)
    jidx, jw = [], []
    for g in _groups(js):
        i, w = jhg._indices_weights_klm(g, jnp.asarray(x))
        jidx.append(np.asarray(i).reshape(-1))
        jw.append(np.asarray(w).reshape(-1))
    tidx, tw = tenc.corners_reference(ts.levels, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.concatenate(jidx))
    np.testing.assert_array_equal(tw.numpy(), np.concatenate(jw))


def _table(rng, st, width):
    # N(0,1) entries so that tolerances relative to scale mean something
    return rng.normal(size=(st.padded_entries, width)).astype(np.float32)


# every interpolation mode, and two configs where every level is hashed and
# the prime products wrap uint32 many times over
_ENCODE_CASES = [(i, {}) for i in INTERPS] + [
    ("hybridc:2", dict(base_resolution=4096, per_level_scale=2.0, log2_hashmap_size=12)),
    ("simplex", dict(base_resolution=4096, per_level_scale=2.0, log2_hashmap_size=12)),
]
_ENCODE_IDS = INTERPS + ["hashed-wrap-mixed", "hashed-wrap-simplex"]


@pytest.mark.parametrize("interp,kw", _ENCODE_CASES, ids=_ENCODE_IDS)
def test_encode_features_and_table_grads_match_jax(interp, kw):
    rng = np.random.default_rng(2)
    jc, tc = _cfgs(interp, **kw)
    js, ts = jhg.build_static(jc), thg.build_static(tc)
    table = _table(rng, js, 2)
    x = rng.uniform(0, 1, (5, 32, 3)).astype(np.float32)
    G = rng.normal(size=(5, 32, js.n_output_dims)).astype(np.float32)

    def jloss(t):
        out = jhg.encode(t, js, jnp.asarray(x))
        return jnp.sum(out * G), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    tout = thg.encode(tt, ts, torch.from_numpy(x))
    (tout * torch.from_numpy(G)).sum().backward()
    assert tout.shape == jout.shape
    assert _rel(tout.detach().numpy(), jout) < 1e-6
    assert _rel(tt.grad.numpy(), jgrad) < 1e-5


@pytest.mark.parametrize("interp", ["trilinear", "hybridc:2"])
def test_encode_pair_fused_matches_jax(interp):
    rng = np.random.default_rng(3)
    jc, tc = _cfgs(interp)
    js, ts = jhg.build_static(jc), thg.build_static(tc)
    fused = _table(rng, js, 4)
    x = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    Ga = rng.normal(size=(64, js.n_output_dims)).astype(np.float32)
    Gb = rng.normal(size=(64, js.n_output_dims)).astype(np.float32)

    def jloss(t):
        a, b = jhg.encode_pair_fused(t, js, jnp.asarray(x))
        return jnp.sum(a * Ga) + jnp.sum(b * Gb), (a, b)

    (_, (ja, jb)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(fused))
    tt = torch.from_numpy(fused).requires_grad_(True)
    ta, tb = thg.encode_pair_fused(tt, ts, torch.from_numpy(x))
    ((ta * torch.from_numpy(Ga)).sum() + (tb * torch.from_numpy(Gb)).sum()).backward()
    assert _rel(ta.detach().numpy(), ja) < 1e-6
    assert _rel(tb.detach().numpy(), jb) < 1e-6
    assert _rel(tt.grad.numpy(), jgrad) < 1e-5


@pytest.mark.parametrize("interp,kw", _ENCODE_CASES, ids=_ENCODE_IDS)
def test_encode_bf16_cast_matches_jax_loosely(interp, kw):
    """bf16 compute on an fp32 table: the port's forward is bit-equal to
    JAX's (rows, weights and each product rounded to bf16, fp32 sum in
    corner order, rounded to bf16), and its table gradient (update
    bf16(bf16(g)·bf16(w)), fp32 sum) agrees to fp32 summation order."""
    rng = np.random.default_rng(4)
    jc, tc = _cfgs(interp, **kw)
    js, ts = jhg.build_static(jc), thg.build_static(tc)
    table = _table(rng, js, 2)
    x = rng.uniform(0, 1, (4096, 3)).astype(np.float32)
    G = rng.normal(size=(4096, js.n_output_dims)).astype(np.float32)

    def jloss(t):
        out = jhg.encode(t, js, jnp.asarray(x), compute_dtype=jnp.bfloat16)
        return jnp.sum(out.astype(jnp.float32) * G), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(table))
    assert jout.dtype == jnp.bfloat16
    tt = torch.from_numpy(table).requires_grad_(True)
    tout = thg.encode(tt, ts, torch.from_numpy(x), compute_dtype=torch.bfloat16)
    (tout * torch.from_numpy(G)).sum().backward()
    assert tout.dtype == torch.float32
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout, np.float32))
    assert _rel(tt.grad.numpy(), jgrad) < 1e-5


@pytest.mark.parametrize("round_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("interp,kw", _ENCODE_CASES, ids=_ENCODE_IDS)
def test_encode_backward_reference_matches_stream_route(interp, kw, round_bf16):
    """The backward that recomputes the corners equals the route that
    stored them: corner streams, per-corner update w·g (bf16 rule), then
    the scatter-add."""
    rng = np.random.default_rng(6)
    _, tc = _cfgs(interp, **kw)
    ts = thg.build_static(tc)
    x = torch.from_numpy(_index_cases(rng))
    N, L, F = x.shape[0], ts.n_levels, 4
    g = torch.from_numpy(rng.normal(size=(N, L, F)).astype(np.float32))
    got = tenc.encode_backward(g, ts.levels, x, ts.padded_entries, round_bf16=round_bf16)

    idx, w = tenc.corners_reference(ts.levels, x)
    gl, wl = g, w
    if round_bf16:
        gl, wl = g.to(torch.bfloat16), w.to(torch.bfloat16)
    upds, start = [], 0
    for lo, hi in tenc.level_groups(ts.levels):  # level-major [K, N] blocks
        K = ts.levels[lo].K
        for lvl in range(lo, hi):
            wk = wl[start : start + K * N].reshape(K, N, 1)
            upds.append((wk * gl[None, :, lvl, :]).to(torch.float32).reshape(-1, F))
            start += K * N
    ref = ths.scatter_add_rows_reference(idx, torch.cat(upds), ts.padded_entries)
    assert got.shape == (ts.padded_entries, F) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref.numpy()) < 1e-6


def test_hash_encode_saves_only_x():
    """The forward keeps the points alone for the backward (no corner
    streams: 72 MB at the flagship)."""
    rng = np.random.default_rng(7)
    _, tc = _cfgs("hybridc:2")
    ts = thg.build_static(tc)
    tt = torch.from_numpy(_table(rng, ts, 4)).requires_grad_(True)
    x = torch.from_numpy(rng.uniform(0, 1, (96, 3)).astype(np.float32))
    out = thg._HashEncode.apply(tt, x, ts.levels, False)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 and torch.equal(saved[0], x)


@pytest.mark.parametrize("fn", ["encode_rows", "encode_backward", "corners"])
def test_encode_wrappers_refuse_non_cpu_non_cuda(fn):
    _, tc = _cfgs("hybridc:2")
    ts = thg.build_static(tc)
    x = torch.zeros(8, 3, device="meta")
    args = {
        "encode_rows": (torch.zeros(ts.padded_entries, 2, device="meta"), ts.levels, x),
        "encode_backward": (torch.zeros(8, ts.n_levels, 2, device="meta"), ts.levels, x, ts.padded_entries),
        "corners": (ts.levels, x),
    }[fn]
    with pytest.raises(ValueError):
        getattr(tenc, fn)(*args)


def test_frequency_encode_matches_jax():
    x = np.random.default_rng(5).uniform(0, 1, (7, 3)).astype(np.float32)
    ref = np.asarray(jhg.frequency_encode(jnp.asarray(x), 4))
    got = thg.frequency_encode(torch.from_numpy(x), 4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_table_init_shape_and_range():
    _, tc = _cfgs("trilinear")
    ts = thg.build_static(tc)
    t = thg.init(torch.Generator().manual_seed(0), ts, device="cpu", width=4)
    assert t.shape == (ts.padded_entries, 4)
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 1e-5
