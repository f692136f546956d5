"""Population training of avr_torch (K trials per step) against the JAX
package's (``make_train_step(population=K)``, ``hpo/population.py``), on the
CPU at the tiny size of tests/test_hpo_population.py, fp32 compute.

The K-batched encode's plain version is held against K single calls and
against ``jax.vmap`` of the JAX encode; the port's population step against
the K = 0 step (bit-equal at K = 1) and against JAX's vmapped step (K = 2),
with params carried over through ``convert`` and JAX's own directions.
The energy-decay and multi-STFT weights are 0 in the step comparison with
JAX, as in the other step-parity tests: their fp32 gradients are not
reproducible even between JAX's own jitted and eager steps.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu import geometry as jgeo
from avr_tpu.config import EncodingConfig
from avr_tpu.losses import CriterionConfig as JCrit
from avr_tpu.losses import criterion as jcriterion
from avr_tpu.models import field as jfield
from avr_tpu.models import hashgrid as jhg
from avr_tpu.render.common import make_consts as jmake_consts
from avr_tpu.train import state as jstate_lib
from conftest import tiny_render_config
from test_hpo_population import tiny_cfg
from test_torch_field import complex_setup
from test_torch_field_standard import standard_config
from test_torch_runner import port_cfg

from avr_torch import geometry as tgeo
from avr_torch.config import EncodingConfig as TEncodingConfig
from avr_torch.convert import params_to_numpy, state_from_jax, state_to_numpy
from avr_torch.data import synthetic
from avr_torch.hpo import population as pop_lib
from avr_torch.hpo.population import PopulationRunner
from avr_torch.losses import CriterionConfig as TCrit
from avr_torch.models import field as tfield
from avr_torch.models import hashgrid as thg
from avr_torch.ops import hashgrid_encode as tenc
from avr_torch.render.common import make_consts as tmake_consts
from avr_torch.train import state as tstate_lib

torch.set_num_threads(2)

INTERPS = ["trilinear", "simplex", "hybridc:2", "hybrid:1", "levels:tsts"]
K = 3


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max() + 1e-30)


# ----------------------------------------------------------------------
# the K-batched encode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("round_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("interp", INTERPS)
def test_encode_pop_matches_single_calls_and_jax_vmap(interp, round_bf16):
    """K tables through one population encode: the features equal K single
    encodes (bit-equal) and ``jax.vmap`` of the JAX encode over the tables
    (bit-equal in the bf16 rule, 1e-6 of scale in fp32); the K table
    gradients equal JAX's to 1e-5 of scale (fp32 sums in another order)."""
    rng = np.random.default_rng(5)
    kw = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=8, base_resolution=4,
              per_level_scale=1.6, interpolation=interp)
    js, ts = jhg.build_static(EncodingConfig(**kw)), thg.build_static(TEncodingConfig(**kw))
    tables = rng.normal(size=(K, js.padded_entries, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (6, 40, 3)).astype(np.float32)
    G = rng.normal(size=(K, 6, 40, js.n_output_dims)).astype(np.float32)
    jdt = jnp.bfloat16 if round_bf16 else None
    tdt = torch.bfloat16 if round_bf16 else None

    def jloss(t, g):
        out = jhg.encode(t, js, jnp.asarray(x), compute_dtype=jdt)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, jout), jgrad = jax.vmap(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(tables), jnp.asarray(G))
    tt = torch.from_numpy(tables).requires_grad_(True)
    tout = thg.encode(tt, ts, torch.from_numpy(x), compute_dtype=tdt)
    (tout * torch.from_numpy(G)).sum().backward()
    assert tout.shape == (K, 6, 40, ts.n_output_dims) and tout.dtype == torch.float32
    jout = np.asarray(jout, np.float32)
    if round_bf16:
        np.testing.assert_array_equal(tout.detach().numpy(), jout)
    else:
        assert _rel(tout.detach().numpy(), jout) < 1e-6
    assert _rel(tt.grad.numpy(), jgrad) < 1e-5

    xf = torch.from_numpy(x.reshape(-1, 3))
    tb = torch.from_numpy(tables)
    pop = tenc.encode_rows_pop(tb, ts.levels, xf, round_bf16)
    for k in range(K):
        np.testing.assert_array_equal(
            pop[k].numpy(), tenc.encode_rows(tb[k], ts.levels, xf, round_bf16).numpy())
    g = torch.from_numpy(G.reshape(K, -1, ts.n_levels, 2))
    d = tenc.encode_backward_pop(g, ts.levels, xf, ts.padded_entries, round_bf16)
    for k in range(K):
        np.testing.assert_array_equal(
            d[k].numpy(),
            tenc.encode_backward(g[k], ts.levels, xf, ts.padded_entries, round_bf16).numpy())


def test_hash_encode_pop_saves_only_x():
    rng = np.random.default_rng(7)
    ts = thg.build_static(TEncodingConfig(n_levels=4, log2_hashmap_size=8, base_resolution=4,
                                          per_level_scale=1.6, interpolation="hybridc:2"))
    tt = torch.from_numpy(rng.normal(size=(2, ts.padded_entries, 4)).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.uniform(0, 1, (96, 3)).astype(np.float32))
    out = thg._HashEncodePop.apply(tt, x, ts.levels, False)
    saved = out.grad_fn.saved_tensors
    assert out.shape == (2, 96, 4, 4) and len(saved) == 1 and torch.equal(saved[0], x)


@pytest.mark.parametrize("fn", ["encode_rows_pop", "encode_backward_pop"])
def test_encode_pop_wrappers_refuse_non_cpu_non_cuda(fn):
    ts = thg.build_static(TEncodingConfig(n_levels=4, log2_hashmap_size=8, base_resolution=4))
    x = torch.zeros(8, 3, device="meta")
    args = {
        "encode_rows_pop": (torch.zeros(2, ts.padded_entries, 2, device="meta"), ts.levels, x),
        "encode_backward_pop": (torch.zeros(2, 8, ts.n_levels, 2, device="meta"), ts.levels, x,
                                ts.padded_entries),
    }[fn]
    with pytest.raises(ValueError):
        getattr(tenc, fn)(*args)


# ----------------------------------------------------------------------
# the render over K trials' params
# ----------------------------------------------------------------------
RENDER_CASES = [("add", 4_000_000), ("concat", 0), ("complex", 4_000_000), ("complex", 0),
                ("frequency_dir", 4_000_000)]


@pytest.mark.parametrize("case,point_budget", RENDER_CASES,
                         ids=[f"{c}-{'precomputed' if b else 'streaming'}" for c, b in RENDER_CASES])
def test_render_over_trials_matches_single_trials(case, point_budget):
    """``render_fused`` of params stacked over 2 trials equals the two
    single-trial renders (1e-6 of scale), and so do the gradients of Σ out·G
    (1e-4, the render parity tests' gradient tolerance): both plans,
    both field variants, channel add and concat, and a parameter-free
    (frequency) encoding, which the trials share."""
    from avr_torch.render.fused import render_fused

    rc = tiny_render_config()
    T = 64
    if case == "complex":
        _, _, p0, fst = complex_setup("hybridc:2", T=T)
    else:
        mcfg = standard_config("add" if case == "frequency_dir" else case, T)
        if case == "frequency_dir":
            mcfg.dir_encoding_sig = EncodingConfig(otype="Frequency", n_frequencies=3)
        fst = tfield.build_field(mcfg, "Real_env")
        p0 = tfield.init(torch.Generator().manual_seed(0), fst, device="cpu")
    leaves0 = dict(tstate_lib.named_leaves(p0))
    trials = [leaves0, {n: t * 1.5 + 0.01 for n, t in leaves0.items()}]
    rng = np.random.default_rng(9)
    bs = 8
    kw = {"dirs": torch.from_numpy(rng.normal(size=(rc.n_azi * rc.n_ele + 2, 3)).astype(np.float32))}
    kw["dirs"] = kw["dirs"] / kw["dirs"].norm(dim=-1, keepdim=True)
    if case == "complex":
        kw["direction_tx"] = kw["dirs"][:bs].clone()
    else:
        kw["ch_idx"] = torch.arange(bs)
    rays_o = torch.from_numpy(rng.uniform(-2, 2, (bs, 3)).astype(np.float32))
    tx = torch.from_numpy(rng.uniform(-2, 2, (bs, 3)).astype(np.float32))
    G = torch.from_numpy(rng.normal(size=(2, bs, T // 2 + 1, 2)).astype(np.float32))
    consts = tmake_consts(rc, T, device="cpu")

    def render(leaves):
        params = tstate_lib.unflatten(p0, leaves)
        return render_fused(params, fst, consts, rc, rays_o, tx, compute_dtype=None, shell_chunk=2,
                            point_budget=point_budget, **kw)

    stacked = {n: torch.stack([t[n] for t in trials]).requires_grad_(True) for n in leaves0}
    out = render(stacked)
    (out * G).sum().backward()
    assert out.shape == (2, bs, T // 2 + 1, 2)
    for k, leaves in enumerate(trials):
        leaves = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
        ref = render(leaves)
        (ref * G[k]).sum().backward()
        assert _rel(out[k].detach(), ref.detach()) < 1e-6
        for n, t in leaves.items():  # fp32 sums over the points in another order
            assert _rel(stacked[n].grad[k], t.grad) < 1e-4, n


# ----------------------------------------------------------------------
# the population step
# ----------------------------------------------------------------------
TRIALS = ((5e-3, 1.0), (1e-4, 20.0))  # (lr, spec_loss_weight) of tests/test_hpo_population.py


def _trial_tcs(jtc, n=2):
    """JAX TrainConfigs of the two trials, energy and multi-STFT weights 0."""
    tcs = []
    for lr, spec_w in TRIALS[:n]:
        t = copy.deepcopy(jtc)
        t.lr, t.spec_loss_weight = lr, spec_w
        t.energy_loss_weight = t.multistft_loss_weight = 0.0
        tcs.append(t)
    return tcs


def _batch(cfg, seed=0):
    bs, F = cfg.train.batch_size, cfg.model.signal_output_dim // 2 + 1
    rng = np.random.default_rng(seed)
    return {
        "wave": (rng.normal(size=(bs, F, 2)) * 1e-2).astype(np.float32),
        "pos_rx": rng.uniform(0.5, 3.5, (bs, 3)).astype(np.float32),
        "pos_tx": rng.uniform(0.5, 3.5, (bs, 3)).astype(np.float32),
    }


def _port_setup(jcfg, tcs, population):
    """The port's step for ``jcfg`` (runtime hparams) and the [K] bundle of ``tcs``."""
    pcfg = port_cfg(jcfg)
    fst = tfield.build_field(pcfg.model, "Simu")
    consts = tmake_consts(pcfg.render, pcfg.model.signal_output_dim, device="cpu")
    step, _ = tstate_lib.make_train_step(
        fst, consts, pcfg.render, pcfg.train, TCrit.from_configs(pcfg.train, pcfg.render),
        population=population,
    )
    hps = []
    for t in tcs:
        ptc = copy.deepcopy(pcfg.train)
        for k in ("lr", "spec_loss_weight", "energy_loss_weight", "multistft_loss_weight"):
            setattr(ptc, k, getattr(t, k))
        hps.append(tstate_lib.make_hparams(ptc))
    return fst, step, hps


def test_population_step_matches_jax_population():
    """One port population step (K = 2) against avr_tpu's vmapped step, from
    the same K-stacked JAX state carried over through ``convert``, on the
    same batch and JAX's own fold_in'd directions, with
    tests/test_hpo_population.py's tolerances: each lane's loss terms to
    rtol 1e-6, its params to rtol 2e-5, atol 1e-7.

    Adam's first step moves an entry by lr·u/(|u| + eps), eps = 1e-8, u the
    clipped gradient; JAX's own vmapped and serial steps (one program) agree
    bitwise, the two frameworks' gradients to a small relative share. So
    every entry whose |u| is above 1e-3 of its leaf's largest (in that lane)
    is held to that tolerance plus what a relative gradient difference of
    1e-3 moves the update by, lr·eps·1e-3·|u|/(|u| + eps)² (nothing unless
    |u| is within a few eps of 0). The entries below, whose gradient is
    within the frameworks' agreement of 0, are held to Adam's bound
    |Δp| ≤ lr, and entries no gradient reaches to exact equality."""
    jcfg = tiny_cfg("/tmp/unused")
    tcs = _trial_tcs(jcfg.train)
    rc = jcfg.render
    jfst = jfield.build_field(jcfg.model, "Simu")
    jconsts = jmake_consts(rc, jcfg.model.signal_output_dim)
    jcrit = JCrit.from_configs(tcs[0], rc)
    stepK, _ = jstate_lib.make_train_step(jfst, jconsts, rc, tcs[0], jcrit, None, population=2)
    state1 = jstate_lib.init_state(jax.random.PRNGKey(0), jfst, tcs[0])
    stateK = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), state1)
    hpK = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *[jstate_lib.make_hparams(t) for t in tcs])
    batch = _batch(jcfg)
    key, it = jax.random.PRNGKey(1), jnp.asarray(3, jnp.int32)
    dirs = np.asarray(jgeo.ray_directions(rc.n_azi, rc.n_ele, key=jax.random.fold_in(key, it)))

    tstate = state_from_jax(jax.device_get(stateK), device="cpu")
    assert tstate.step.shape == (2,)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jrender = jstate_lib.make_train_step(jfst, jconsts, rc, tcs[0], jcrit, None)

    def jloss(p, hp):
        pred = jrender(p, jbatch, jnp.asarray(dirs))
        return jcriterion(pred, jbatch["wave"], jcrit, weights=hp)[0].total

    jgrad = jax.device_get(jax.vmap(jax.grad(jloss))(stateK.params, hpK))
    p_before = jax.device_get(stateK.params)
    _, tstep, hps = _port_setup(jcfg, tcs, population=2)
    jnew, jb = stepK(stateK, {k: jnp.asarray(v) for k, v in batch.items()}, key, it, hpK)
    tnew, tb = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(dirs),
                     tstate_lib.stack_hparams(hps))

    assert tb.total.shape == (2,) and tnew.step.tolist() == [1, 1]
    for name in jb._fields:
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), rtol=1e-6)
    jl = jax.tree_util.tree_leaves(jax.device_get(jnew.params))
    tl = jax.tree_util.tree_leaves(params_to_numpy(tnew.params))
    gl = jax.tree_util.tree_leaves(jgrad)
    pl = jax.tree_util.tree_leaves(p_before)
    assert len(jl) == len(tl) == len(gl) == len(pl)
    g_norm = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)).reshape(2, -1), axis=1) for g in gl))
    clip = np.minimum(1.0, 1.0 / g_norm)
    n_sure = n_moved = 0
    for a, b, g, pb in zip(jl, tl, gl, pl):
        assert a.shape == b.shape and a.shape[0] == 2
        for k, (lr, _) in enumerate(TRIALS):
            assert np.all(np.abs(b[k] - pb[k]) <= lr * (1 + 1e-3) + 1e-7)  # Adam's bound
            u_abs = np.abs(g[k]) * clip[k]
            np.testing.assert_array_equal(b[k][u_abs == 0], a[k][u_abs == 0])
            sure = u_abs > 1e-3 * u_abs.max()
            n_sure, n_moved = n_sure + int(sure.sum()), n_moved + int((u_abs > 0).sum())
            u = u_abs[sure]
            tol = 1e-7 + 2e-5 * np.abs(a[k][sure]) + lr * 1e-8 * 1e-3 * u / (u + 1e-8) ** 2
            assert np.all(np.abs(b[k][sure] - a[k][sure]) <= tol)
    assert n_sure > 0.7 * n_moved, (n_sure, n_moved)  # the tight tolerance covers most moved entries
    la = tl[0]
    assert not np.allclose(la[0], la[1])  # the lanes diverged (another lr)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_population_step_k1_bit_equal_to_plain_step(compute_dtype):
    """A population of one trial takes exactly the single-trial step: two
    steps of population=1 and of population=0 (the runtime-hparam step) give
    bit-equal bundles, params and moments."""
    jcfg = tiny_cfg("/tmp/unused")
    jcfg.train.compute_dtype = compute_dtype
    tcs = _trial_tcs(jcfg.train, n=1)
    fst, step0, hps = _port_setup(jcfg, tcs, population=0)
    _, step1, _ = _port_setup(jcfg, tcs, population=1)
    s0 = tstate_lib.init_state(torch.Generator().manual_seed(0), fst, port_cfg(jcfg).train, device="cpu")
    s1 = tstate_lib.stack_states([s0])
    hp1 = tstate_lib.stack_hparams(hps)
    gen = torch.Generator().manual_seed(3)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, seed=i).items()}
        dirs = tgeo.ray_directions(jcfg.render.n_azi, jcfg.render.n_ele, generator=gen, device="cpu")
        s0, b0 = step0(s0, batch, dirs, hps[0])
        s1, b1 = step1(s1, batch, dirs, hp1)
        for name in b0._fields:
            assert torch.equal(getattr(b1, name), getattr(b0, name)[None]), name
    a, b = state_to_numpy(s0), state_to_numpy(s1)
    assert b["step"] == [a["step"]] == [2]
    for part in ("params", "mu", "nu"):
        for x, y in zip(jax.tree_util.tree_leaves(a[part]), jax.tree_util.tree_leaves(b[part])):
            np.testing.assert_array_equal(y[0], x)


def test_runtime_step_takes_the_jax_runtime_schedule():
    """The runtime-hparam step (the runner's ``runtime_hparams``) applies
    JAX's runtime rate eta_min + (lr − eta_min)·cosf, not the static
    schedule's alpha form, which rounds otherwise in fp32; the logged rate
    is the applied one."""
    jcfg = tiny_cfg("/tmp/unused")
    ptc = port_cfg(jcfg).train
    hp = tstate_lib.make_hparams(ptc)
    jhp = jstate_lib.make_hparams(jcfg.train)
    steps = np.arange(0, 60)
    got = tstate_lib.cosine_lr_hp(hp, torch.from_numpy(steps).to(torch.int32)).numpy()
    ref = np.asarray(jax.vmap(lambda s: jstate_lib._cosine_lr(jhp, s))(jnp.asarray(steps, jnp.int32)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)  # torch and XLA round cos apart
    assert [tstate_lib.current_lr(ptc, int(s)) for s in steps] == got.tolist()
    static = np.asarray([float(tstate_lib.cosine_lr(ptc, torch.tensor(int(s)))) for s in steps])
    assert not np.array_equal(static, got)  # the two formulas round differently


def test_array_recipe_schedules_differ_in_rounding_only():
    """Over the whole schedule of configs/avr_synthetic_array.yml the static
    and the runtime formula give other fp32 rates at some steps, never more
    than 1e-6 apart relative to the rate."""
    from avr_torch.config import AVRConfig

    tc = AVRConfig.from_yaml(os.path.join(os.path.dirname(__file__), "..", "configs",
                                          "avr_synthetic_array.yml")).train
    steps = torch.arange(0, tc.T_max + 1, dtype=torch.int32)
    static = tstate_lib.cosine_lr(tc, steps)
    runtime = tstate_lib.cosine_lr_hp(tstate_lib.make_hparams(tc), steps)
    assert not torch.equal(static, runtime)
    assert float(((static - runtime).abs() / runtime).max()) < 1e-6


def test_runtime_step_defaults_to_the_config_bundle():
    """With runtime_hparams and no bundle given (the runner's call), the step
    takes ``make_hparams`` of its config: bit-equal to passing it."""
    jcfg = tiny_cfg("/tmp/unused")
    fst, step, hps = _port_setup(jcfg, [jcfg.train], population=0)
    s0 = tstate_lib.init_state(torch.Generator().manual_seed(0), fst, port_cfg(jcfg).train, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    dirs = tgeo.ray_directions(jcfg.render.n_azi, jcfg.render.n_ele, generator=torch.Generator().manual_seed(2),
                               device="cpu")
    (a, ba), (b, bb) = step(s0, batch, dirs), step(s0, batch, dirs, hps[0])
    assert all(torch.equal(x, y) for x, y in zip(ba, bb))
    for x, y in zip(jax.tree_util.tree_leaves(state_to_numpy(a)), jax.tree_util.tree_leaves(state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# PopulationRunner
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    room = synthetic.RoomSpec(size=(4.0, 3.0, 2.5), max_order=2, fs=4000, seq_len=256)
    d = str(tmp_path_factory.mktemp("simu_pop"))
    synthetic.write_simu_dataset(d, room, n=24)
    return d


def _runner_cfgs(logdir, lrs=(5e-3, 1e-6), **train_kw):
    cfgs = []
    for i, lr in enumerate(lrs):
        c = port_cfg(tiny_cfg(logdir, name=f"trial{i}", lr=lr), **train_kw)
        c.train.runtime_hparams = True
        cfgs.append(c)
    return cfgs


def test_population_runner_end2end(tmp_path, dataset_dir, monkeypatch):
    """K = 2 trials in lockstep write each trial's val_iter npz in the
    runner's layout, their predictions differ, and the logged rate counts
    every step since the previous log (the JAX runner counts only the last
    call's steps)."""
    cfgs = _runner_cfgs(str(tmp_path / "pop"))
    clock = iter(float(i) for i in range(1000))  # each reading 1 s after the last
    monkeypatch.setattr(pop_lib.time, "time", lambda: next(clock))
    lines = []
    pop = PopulationRunner(cfgs, dataset_dir, device="cpu")
    pop.train(log=lines.append)
    assert pop.state.step.tolist() == [8, 8]
    tc = cfgs[0].train
    assert len(lines) == tc.total_iterations // tc.log_freq
    per_log = tc.log_freq * 2 * tc.batch_size  # samples of both trials per 1-s interval
    assert all(line.endswith(f"({per_log} samp/s)") for line in lines), lines

    preds = []
    for i in range(2):
        npz_dir = os.path.join(str(tmp_path / "pop"), f"trial{i}", "val_result")
        assert sorted(os.listdir(npz_dir)) == ["val_iter000004.npz", "val_iter000008.npz"]
        z = np.load(os.path.join(npz_dir, "val_iter000008.npz"))
        for key in ("ori_sig", "pred_sig", "position_rx", "position_tx", "fs"):
            assert key in z, key
        assert z["pred_sig"].dtype == np.complex64 and z["pred_sig"].shape == z["ori_sig"].shape
        preds.append(z["pred_sig"])
    assert not np.allclose(preds[0], preds[1])


def test_population_runner_steps_per_call_is_bit_equal(tmp_path, dataset_dir):
    """steps_per_call = 2 runs the same population steps as 1."""
    states = []
    for spc in (1, 2):
        cfgs = _runner_cfgs(str(tmp_path / f"spc{spc}"), steps_per_call=spc, total_iterations=4,
                            val_freq=100)
        pop = PopulationRunner(cfgs, dataset_dir, device="cpu")
        pop.train(log=lambda *a: None)
        states.append(state_to_numpy(pop.state))
    assert states[0]["step"] == states[1]["step"] == [4, 4]
    for x, y in zip(jax.tree_util.tree_leaves(states[0]["params"]), jax.tree_util.tree_leaves(states[1]["params"])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("change", ["n_samples", "static_runtime_hparams"])
def test_population_refuses_a_structural_mismatch(tmp_path, dataset_dir, change):
    cfgs = _runner_cfgs(str(tmp_path / "bad"))
    if change == "n_samples":
        cfgs[1].render.n_samples = 16  # structural: another model of the render
        with pytest.raises(ValueError, match="structurally"):
            PopulationRunner(cfgs, dataset_dir, device="cpu")
    else:
        for c in cfgs:
            c.train.runtime_hparams = False
        with pytest.raises(ValueError, match="runtime_hparams"):
            PopulationRunner(cfgs, dataset_dir, device="cpu")


def test_population_runner_defaults_to_the_card(tmp_path, dataset_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PopulationRunner(_runner_cfgs(str(tmp_path / "card")), dataset_dir)
