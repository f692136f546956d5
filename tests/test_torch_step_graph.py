"""The train step as one CUDA graph (``avr_torch.train.state._StepGraph``).

On the CPU: the step stays eager and functional, ``apply_optimizer(...,
out=)`` is bit-equal to the functional update, ``_writable`` copies exactly
the leaves a graph may not write into, the scene box rides in
``RenderConsts``, the criterion's host-built constants are built once, and
the two backwards written without a host read (``ops.take``, the
transmittance's cumprod) are bit-equal to autograd's.
Tests marked ``card`` hold the graphed step against eager steps on a CUDA
card (a fresh step closure runs its first call eagerly) and skip without
one: this file imports neither JAX nor the conftest's helpers, so on the
card it runs as ``python -m pytest --noconftest -m card
tests/test_torch_step_graph.py``.
"""

from __future__ import annotations

import dataclasses
import gc
from pathlib import Path

import numpy as np
import pytest
import torch

from avr_torch import geometry
from avr_torch.config import AVRConfig, EncodingConfig, MLPConfig, TrainConfig
from avr_torch.flagship import flagship_config
from avr_torch.losses import CriterionConfig
from avr_torch.models import field
from avr_torch.ops import stft
from avr_torch.ops.take import take
from avr_torch.render.common import compositing_weights, make_consts
from avr_torch.render.fused import render_fused
from avr_torch.train import state as st
from avr_torch.utils import profiling

torch.set_num_threads(2)

ARRAY_RECIPE = Path(__file__).resolve().parents[1] / "configs" / "avr_synthetic_array.yml"
STEPS = 4
NAN_STEP = 2  # the step (from 0) whose batch holds a non-finite wave: a replay


# ----------------------------------------------------------------------
# Small configurations of both field variants
# ----------------------------------------------------------------------
def complex_config():
    """The flagship's complex field (fused ``pos_pair`` table) at small widths:
    20 rays × 4 shells in 2 checkpointed chunks, T = 128, bf16 compute. The
    energy term's weight is 0, as in the train tests' step parity: its
    gradient is not reproducible in fp32. A non-finite energy still skips."""
    cfg = flagship_config(small=True)
    cfg.train = dataclasses.replace(cfg.train, shell_chunk=2, energy_loss_weight=0.0)
    return cfg


def standard_config(population: int = 0):
    """The array recipe (standard field, ``add`` channel embeddings, DAS
    regression) at small widths: 4 levels of 2^8 rows, MLPs 32 wide, 20 rays
    × 4 shells in 2 chunks, T = 128, bf16 compute, energy weight 0 (as
    ``complex_config``); runtime hyper-parameters for a population."""
    cfg = AVRConfig.from_yaml(str(ARRAY_RECIPE))
    rc, m = cfg.render, cfg.model
    rc.n_samples, rc.n_azi, rc.n_ele = 4, 6, 3
    m.signal_output_dim = 128
    enc = EncodingConfig(n_levels=4, log2_hashmap_size=8, base_resolution=4, per_level_scale=1.5)
    m.pos_encoding_sigma = m.dir_encoding_sig = m.tx_encoding_sig = enc
    for name in ("sigma_encoder_network", "sigma_decoder_network", "signal_network"):
        setattr(m, name, MLPConfig(n_neurons=32, n_hidden_layers=2))
    cfg.train = dataclasses.replace(cfg.train, shell_chunk=2, energy_loss_weight=0.0,
                                    runtime_hparams=bool(population))
    return cfg


class Setup:
    """A configuration's field, constants, criterion, initial state (K
    trials stacked) and, for K, a runtime bundle whose trials differ in rate."""

    def __init__(self, cfg, device, population: int = 0, compute_dtype=None):
        if compute_dtype is not None:
            cfg.train = dataclasses.replace(cfg.train, compute_dtype=compute_dtype)
        self.cfg, self.device, self.K = cfg, device, population
        self.rc, self.tc = cfg.render, cfg.train
        self.fst = field.build_field(cfg.model, cfg.path.dataset_type)
        self.consts = make_consts(self.rc, cfg.model.signal_output_dim, device=device)
        self.crit = CriterionConfig.from_configs(self.tc, self.rc)
        state = st.init_state(torch.Generator(device=device).manual_seed(0), self.fst, self.tc, device=device)
        self.state = st.stack_states([state] * population) if population else state
        self.hp = None
        if population:  # K trials that differ in their rate
            tcs = [dataclasses.replace(self.tc, lr=self.tc.lr / (k + 1)) for k in range(population)]
            self.hp = st.stack_hparams([st.make_hparams(t, device) for t in tcs])

    def step(self):
        """A new step closure: its first call of a key runs eagerly."""
        return st.make_train_step(self.fst, self.consts, self.rc, self.tc, self.crit, population=self.K)[0]

    def batches(self, n: int, bs: int = 0, nan_step: int = -1):
        """n batches drawn on the host from seed 7 and moved to the device:
        one 8-microphone group (standard variant) or bs rows with a view."""
        g = torch.Generator().manual_seed(7)
        F = self.cfg.model.signal_output_dim // 2 + 1
        group = self.fst.variant == "standard"
        bs = 8 if group else bs or 2
        out = []
        for i in range(n):
            b = {
                "wave": torch.randn((bs, F, 2), generator=g) * 1e-2,
                "pos_rx": torch.rand((bs, 3), generator=g) * 4 - 2,
                "pos_tx": torch.rand((bs, 3), generator=g) * 4 - 2,
            }
            if group:
                b["ch_idx"] = torch.arange(8, dtype=torch.int32)
            else:
                b["rot_tx"] = torch.nn.functional.normalize(torch.randn((bs, 3), generator=g), dim=-1)
            if i == nan_step:
                b["wave"][0, 3, 0] = float("nan")
            out.append({k: v.to(self.device) for k, v in b.items()})
        return out

    def dirs(self, i: int):
        g = torch.Generator().manual_seed(100 + i)
        return geometry.ray_directions(self.rc.n_azi, self.rc.n_ele, generator=g, device=self.device)

    def call(self, step, state, batch, third):
        return step(state, batch, third, self.hp) if self.K else step(state, batch, third)


def leaves(s: st.TrainState):
    return st._state_leaves(s)


def clone_state(s: st.TrainState) -> st.TrainState:
    return st._with_leaves(s, [t.clone() for t in leaves(s)])


def per_step_counts(fn):
    """fn()'s result and the counters it moved (the tracer's ``step.*`` apart)."""
    profiling.drain()
    out = fn()
    counts = profiling.drain()[1]
    return out, {k: v for k, v in counts.items() if not k.startswith("step.")}, \
        {k: v for k, v in counts.items() if k.startswith("step.")}


# ----------------------------------------------------------------------
# On the CPU
# ----------------------------------------------------------------------
def tiny_standard_setup(population: int = 0) -> Setup:
    """The standard setup at a size the CPU steps in well under a second, fp32."""
    cfg = standard_config(population)
    enc = EncodingConfig(n_levels=2, log2_hashmap_size=6, base_resolution=2, per_level_scale=1.5)
    cfg.model.pos_encoding_sigma = cfg.model.dir_encoding_sig = cfg.model.tx_encoding_sig = enc
    for name in ("sigma_encoder_network", "sigma_decoder_network", "signal_network"):
        setattr(cfg.model, name, MLPConfig(n_neurons=16, n_hidden_layers=1))
    cfg.model.signal_output_dim = 64
    return Setup(cfg, torch.device("cpu"), population, compute_dtype="float32")


@pytest.mark.parametrize("population", [0, 2])
def test_cpu_step_stays_eager_and_functional(population):
    """On the CPU every call runs eagerly: each returns a fresh state, the
    state it was given is left as it was, and no ``step.*`` counter moves."""
    s = tiny_standard_setup(population)
    step = s.step()
    state = s.state
    profiling.drain()
    for i, batch in enumerate(s.batches(3)):
        kept = clone_state(state)
        new, _ = s.call(step, state, batch, s.dirs(i))
        assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(kept)))
        assert not any(a is b for a, b in zip(leaves(new), leaves(state)))
        state = new
    counts = profiling.drain()[1]
    assert not any(k.startswith("step.") for k in counts), counts
    assert torch.equal(state.step, torch.full_like(state.step, 3))


def _random_state(shapes, K: int, seed: int) -> st.TrainState:
    g = torch.Generator().manual_seed(seed)
    lead = (K,) if K else ()

    def tree(scale):
        return {n: torch.randn(lead + sh, generator=g) * scale for n, sh in shapes.items()}

    nu = st.tree_map(torch.abs, tree(1e-4))
    step = torch.tensor([3, 0, 5][:K] if K else 3, dtype=torch.int32)
    return st.TrainState(tree(0.1), st.AdamState(tree(1e-2), nu), step)


@pytest.mark.parametrize("population, runtime", [(0, False), (0, True), (3, True)])
def test_apply_optimizer_out_is_bit_equal_to_the_fresh_update(population, runtime):
    """The update written into the state's own tensors equals the fresh
    state bit for bit, with and without a skipped step (per trial for K),
    and the tensors written are the ones given."""
    shapes = {"a": (5, 3), "b.w": (7,), "c": (2, 4, 2)}
    state = _random_state(shapes, population, 0)
    grads = _random_state(shapes, population, 1).params
    grads["b.w"][..., 2] = float("inf")  # a non-finite entry is zeroed
    tc = TrainConfig(lr=1e-3, eta_min=1e-4, T_max=10, weight_decay=1e-2, runtime_hparams=runtime)
    hp = None
    if runtime:
        hps = [st.make_hparams(dataclasses.replace(tc, lr=1e-3 / (k + 1))) for k in range(max(1, population))]
        hp = st.stack_hparams(hps) if population else hps[0]
    skips = [torch.tensor([False, True, False][:population]) if population else torch.tensor(v) for v in (False, True)]
    for skip in skips:
        fresh = st.apply_optimizer(state, grads, tc, skip, hp)
        into = clone_state(state)
        out = st.apply_optimizer(into, grads, tc, skip, hp, out=into)
        assert out is into
        for a, b in zip(leaves(fresh), leaves(out)):
            assert torch.equal(a, b)


def test_writable_keeps_whole_leaves_and_copies_the_rest():
    """A leaf alone on its whole storage is kept; a view (a ``lane``), a
    second leaf on the same tensor and a transposed leaf are copied."""
    whole = torch.randn(4, 3)
    stacked = torch.randn(2, 5)
    lane = stacked[1]
    t = torch.randn(3, 4).t()
    got = st._writable([whole, lane, whole, t])
    assert got[0] is whole
    for a, b in zip(got[1:], [lane, whole, t]):
        assert a is not b and torch.equal(a, b) and a.is_contiguous()
    ptrs = {x.untyped_storage().data_ptr() for x in got}
    assert len(ptrs) == 4


def test_render_consts_carry_the_box_and_the_render_is_unchanged():
    """``make_consts`` holds the scene box as fp32 tensors equal to those the
    renderer built from ``rc`` on every call before, and the render from
    them is bit-equal to the render from the box built that way."""
    s = tiny_standard_setup()
    rc, consts = s.rc, s.consts
    old = [torch.tensor(v, dtype=torch.float32) for v in (rc.xyz_min, rc.xyz_max)]
    assert torch.equal(consts.xyz_min, old[0]) and torch.equal(consts.xyz_max, old[1])
    batch = s.batches(1)[0]
    kw = dict(ch_idx=batch["ch_idx"].long(), dirs=s.dirs(0), compute_dtype=None, shell_chunk=2)
    args = (s.state.params, s.fst)
    new = render_fused(*args, consts, rc, batch["pos_rx"], batch["pos_tx"], **kw)
    before = render_fused(*args, consts._replace(xyz_min=old[0], xyz_max=old[1]), rc,
                          batch["pos_rx"], batch["pos_tx"], **kw)
    assert torch.equal(new, before)


def test_criterion_constants_are_built_once_and_unchanged():
    """The Hann window and the STFT's frame index are built once per
    arguments (a step copies nothing from the host) and equal the numpy
    construction."""
    w = stft.hann_window(75, torch.float32, torch.device("cpu"))
    assert stft.hann_window(75, torch.float32, torch.device("cpu")) is w
    n = np.arange(75)
    assert torch.equal(w, torch.from_numpy((0.5 * (1.0 - np.cos(2.0 * np.pi * n / 75))).astype(np.float32)))
    idx = stft._frame_index(100, 64, 4, True, "reflect", torch.device("cpu"))
    assert stft._frame_index(100, 64, 4, True, "reflect", torch.device("cpu")) is idx
    src = np.pad(np.arange(100), 32, mode="reflect")  # pads shorter than the signal: one reflection
    n_frames = 1 + (src.shape[0] - 64) // 4
    want = src[np.arange(n_frames)[:, None] * 4 + np.arange(64)[None, :]]
    assert np.array_equal(idx.numpy(), want)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_take_matches_indexing_and_its_gradient_bit_for_bit(dim):
    """``take`` (the STFT's frames, the embedding rows) gives autograd's
    indexing and gradient, repeated indices summed, without its host check."""
    g = torch.Generator().manual_seed(dim)
    x = torch.randn((4, 6, 5), generator=g)
    idx = torch.randint(0, x.shape[dim], (3, 7), generator=g)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    got = take(a, dim, idx)
    want = b[(slice(None),) * dim + (idx,)]
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=g)
    got.backward(cot)
    want.backward(cot)
    assert torch.equal(a.grad, b.grad)


def test_compositing_weights_gradient_is_cumprods():
    """The transmittance's cumprod backward without autograd's zero test is
    bit-equal to autograd's, whose factors are never 0 here."""
    g = torch.Generator().manual_seed(3)
    attn = torch.rand((2, 5, 9), generator=g) * 4
    d = torch.linspace(0.1, 3.0, 9)
    a, b = attn.clone().requires_grad_(), attn.clone().requires_grad_()
    got = compositing_weights(a, d)
    dists = torch.cat([d[1:] - d[:-1], d.new_full((1,), 1e10)])
    alpha = 1.0 - torch.exp(-b * dists)
    one = torch.ones((2, 5, 1))
    want = torch.cumprod(torch.cat([one, 1.0 - alpha + 1e-6], dim=-1), dim=-1)[..., :-1] * alpha
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=g)
    got.backward(cot)
    want.backward(cot)
    assert torch.equal(a.grad, b.grad)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph only there")
    return torch.device("cuda", 0)


def _free():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def adam_bound(count: int, b1: float = 0.9, b2: float = 0.999) -> float:
    """The largest |m̂|/√v̂ of Adam after ``count`` updates, over all gradient
    sequences: √(Σ_i a_i²/b_i) with a_i, b_i the bias-corrected weights of
    gradient i in m̂ and v̂ (Cauchy–Schwarz); 1 after one update, 1.0014 after
    two, 1.0068 after four. An update moves an entry by at most lr times it."""
    a = [(1 - b1) * b1 ** (count - i) / (1 - b1 ** count) for i in range(1, count + 1)]
    b = [(1 - b2) * b2 ** (count - i) / (1 - b2 ** count) for i in range(1, count + 1)]
    return sum(x * x / y for x, y in zip(a, b)) ** 0.5


def assert_steps_close(eager, graphed, lr: float):
    """Graphed steps against eager ones from the same states, with the
    step-parity tolerances of ``tests/test_torch_train.py``: per step k the
    loss terms within 1e-5 of max(|term|, 1); every update within Adam's
    bound (``adam_bound``, the tests' lr·(1 + 1e-3) past two updates);
    entries whose eager first moment is 0 (rows no point touched) equal;
    entries whose eager first moment m exceeds 1e-3 of its leaf's largest
    within k·lr·(2e-3 + 1e-3·max|m|/|m|) + 1e-7. Not bit for bit: the encode
    backward's atomics add in another order each run."""
    for k, ((before, e_state, e_bundle), (g_state, g_bundle)) in enumerate(zip(eager, graphed), start=1):
        for name, a, b in zip(e_bundle._fields, g_bundle, e_bundle):
            assert torch.equal(torch.isfinite(a), torch.isfinite(b)), (k, name, a, b)
            ok = torch.isfinite(b)
            assert torch.all((a - b).abs()[ok] <= 1e-5 * torch.clamp(b.abs()[ok], min=1.0)), (k, name, a, b)
        assert torch.equal(g_state.step, e_state.step), k
        move = lr * max(1 + 1e-3, adam_bound(max(1, int(e_state.step.max())))) + 1e-7
        p0 = dict(st.named_leaves(before.params))
        pe = dict(st.named_leaves(e_state.params))
        pg = dict(st.named_leaves(g_state.params))
        mu = dict(st.named_leaves(e_state.opt_state.mu))
        for n, m in mu.items():
            worst = float((pg[n] - p0[n]).abs().max())
            assert worst <= move, (k, n, "update", worst, move)
            zero = m == 0
            assert torch.equal(pg[n][zero], pe[n][zero]), (k, n, "untouched rows")
            m_abs = m.abs()
            sure = m_abs > 1e-3 * m_abs.max()
            tol = k * lr * (2e-3 + 1e-3 * m_abs.max() / m_abs[sure]) + 1e-7
            over = float(((pg[n][sure] - pe[n][sure]).abs() / tol).max()) if sure.any() else 0.0
            assert over <= 1, (k, n, "against eager, share of the limit", over)


def run_both(s: Setup, generator: bool):
    """STEPS steps of one step closure (graphed from its second call) and the
    same steps each taken by a fresh closure (eager) from the graphed run's
    state before it; the batch of NAN_STEP has a non-finite wave. Returns
    (eager [(state before, state after, bundle)], graphed [(state after,
    bundle)] as copies, the counters each call moved, apart from and of
    ``step.*``, and the graphed run's last state and step)."""
    batches = s.batches(STEPS, nan_step=NAN_STEP)
    gens = [torch.Generator(device=s.device).manual_seed(5) for _ in range(2)]
    step = s.step()
    state = s.state
    eager, graphed, counts = [], [], []
    for i, batch in enumerate(batches):
        before = clone_state(state)
        # the eager step draws the same directions as the graphed one
        third_e, third_g = (gens[0], gens[1]) if generator else (s.dirs(i), s.dirs(i))
        (e_state, e_bundle), e_counts, _ = per_step_counts(lambda: s.call(s.step(), before, batch, third_e))
        (state, bundle), g_counts, g_steps = per_step_counts(lambda: s.call(step, state, batch, third_g))
        eager.append((before, e_state, e_bundle))
        graphed.append((clone_state(state), bundle, [t.clone() for t in bundle]))
        counts.append((e_counts, g_counts, g_steps))
    return eager, graphed, counts, state, step


def check_run(s: Setup, generator: bool):
    eager, graphed, counts, state, _ = run_both(s, generator)
    lr = float(s.hp["lr"].max()) if s.K else s.tc.lr
    assert_steps_close(eager, [g[:2] for g in graphed], lr)
    # the step at NAN_STEP, a replay, keeps params, moments and step as they were
    before, after = eager[NAN_STEP][0], graphed[NAN_STEP][0]
    assert all(torch.equal(a, b) for a, b in zip(leaves(before), leaves(after)))
    assert not torch.isfinite(graphed[NAN_STEP][1].energy).any()
    want_steps = [{"step.eager_calls": 1}, {"step.graph_captures": 1, "step.graph_replays": 1}] + \
        [{"step.graph_replays": 1}] * (STEPS - 2)
    for i, (e_counts, g_counts, g_steps) in enumerate(counts):
        assert g_counts == e_counts, i  # the replays add the capture's counts again
        assert g_steps == want_steps[i], i
    for e_counts, _, _ in counts:
        assert e_counts["render.chunk_calls"] == 4  # 2 chunks, each recomputed once
        assert {"contract.fwd_launches", "mlp_act.fwd_launches"} <= set(e_counts)
        assert any(k.startswith("encode.") for k in e_counts)
    # every loss bundle returned is the caller's: later replays do not rewrite it
    for _, bundle, values in graphed:
        assert all(torch.equal(a, b) or torch.isnan(a).all() and torch.isnan(b).all()
                   for a, b in zip(bundle, values))
    return state


@pytest.mark.card
def test_card_graphed_complex_steps_match_eager(card):
    """The complex field (fused ``pos_pair`` table), directions drawn from a
    generator: 4 steps, graphed against eager."""
    check_run(Setup(complex_config(), card), generator=True)


@pytest.mark.card
def test_card_graphed_standard_steps_match_eager(card):
    """The array recipe's standard field with ``add`` channels and the DAS
    regression, one 8-mic group, directions given: 4 steps."""
    check_run(Setup(standard_config(), card), generator=False)


@pytest.mark.card
def test_card_graphed_population_steps_match_eager(card):
    """K = 2 trials of the standard field in lockstep, differing in rate."""
    state = check_run(Setup(standard_config(population=2), card, population=2), generator=False)
    assert state.step.tolist() == [STEPS - 1] * 2


@pytest.mark.card
def test_card_another_batch_size_runs_eagerly_and_a_foreign_state_is_copied_in(card):
    """After the capture: a call of another batch size runs eagerly (a fresh
    state, ``step.eager_calls``), a call with a state that is not the
    graph's has it copied into the graph's tensors and replays, leaving the
    state it was given as it was; both against eager steps."""
    s = Setup(complex_config(), card)
    step = s.step()
    b2, b3 = s.batches(4), s.batches(1, bs=3)[0]
    state = s.state
    for i in range(2):  # eager, then the capture
        state, _ = step(state, b2[i], s.dirs(i))
    graph_leaves = leaves(state)

    kept = clone_state(state)
    (other, o_bundle), _, counted = per_step_counts(lambda: step(state, b3, s.dirs(2)))
    assert counted == {"step.eager_calls": 1}
    assert all(torch.equal(a, b) for a, b in zip(leaves(state), leaves(kept)))
    assert not any(a is b for a, b in zip(leaves(other), graph_leaves))
    e_state, e_bundle = s.step()(kept, b3, s.dirs(2))
    assert_steps_close([(kept, e_state, e_bundle)], [(other, o_bundle)], s.tc.lr)

    foreign = clone_state(other)  # a state of the captured key that is not the graph's
    (new, bundle), _, counted = per_step_counts(lambda: step(foreign, b2[3], s.dirs(3)))
    assert counted == {"step.graph_replays": 1}
    assert all(a is b for a, b in zip(leaves(new), graph_leaves))
    assert all(torch.equal(a, b) for a, b in zip(leaves(foreign), leaves(other)))
    e_state, e_bundle = s.step()(foreign, b2[3], s.dirs(3))
    assert_steps_close([(foreign, e_state, e_bundle)], [(new, bundle)], s.tc.lr)


@pytest.mark.card
def test_card_graph_peaks_no_higher_than_eager_and_is_freed_with_its_step(card):
    """No graphed call (the capture, a replay) peaks above the eager first
    call. ``del step; gc.collect(); torch.cuda.empty_cache()`` leaves
    allocated what the steps' caller holds: its state, no byte of the
    graph's pool or buffers. The first round fills the criterion's constants
    and the libraries' per-stream workspaces, which stay."""
    s = Setup(standard_config(), card)
    batches = s.batches(STEPS)

    def four_steps():
        step, state, peaks = s.step(), s.state, []
        for i, batch in enumerate(batches):
            torch.cuda.reset_peak_memory_stats(card)
            state, _ = step(state, batch, s.dirs(i))
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated(card))
        return step, state, peaks

    step, state, _ = four_steps()
    del step, state
    _free()
    base = torch.cuda.memory_allocated(card)
    step, state, peaks = four_steps()
    assert max(peaks[1:]) <= peaks[0], peaks
    held = sum(-(-t.numel() * t.element_size() // 512) * 512 for t in leaves(state))
    del step
    _free()
    assert torch.cuda.memory_allocated(card) == base + held
    del state
    _free()
    assert torch.cuda.memory_allocated(card) == base
