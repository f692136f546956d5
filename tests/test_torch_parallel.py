"""The port's data × ray plan (``avr_torch/parallel/mesh.py``) on the CPU:
2 or 3 spawned ranks joined by gloo (``torch_ranks.py``), at the tiny
config of tests/test_train.py with fp32 compute.

A plan step is held against the port's single-process step and against
JAX's mesh step on the virtual CPU devices (``make_mesh_plan(batch_size=4)``
as ``test_sharded_step_matches_single_device`` builds it), with that test's
tolerances: loss rtol 1e-5, params rtol 1e-4 and atol 1e-6. Every rank's
params must be bit-equal. The energy-decay and multi-STFT weights are 0:
JAX's jitted fp32 gradients of those terms do not reproduce themselves
(tests/test_torch_train.py).

Against JAX the params tolerance holds on every entry whose clipped
gradient u is above 1e-3 of its leaf's largest, plus what a relative
gradient difference of 1e-3 moves Adam's first update lr·u/(|u| + eps) by,
as tests/test_torch_population.py holds the frameworks' steps: an entry
whose gradient is within the frameworks' agreement of 0 can move either
way, and is held to Adam's bound |Δp| ≤ lr; an entry no gradient reaches
stays exactly where it was.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ranks
from avr_tpu import geometry as jgeo
from avr_tpu.data import synthetic as jsynth
from avr_tpu.data.loaders import load_dataset
from avr_tpu.data.sampler import BatchSampler
from avr_tpu.losses import CriterionConfig as JCrit
from avr_tpu.models import field as jfield
from avr_tpu.parallel.mesh import make_mesh_plan as jmake_mesh_plan
from avr_tpu.render.common import make_consts as jmake_consts
from avr_tpu.train import state as jstate_lib
from test_torch_runner import jax_cfg, port_cfg

from avr_torch.convert import params_from_jax, params_to_numpy
from avr_torch.losses import CriterionConfig, criterion
from avr_torch.models import field
from avr_torch.parallel import mesh
from avr_torch.render.common import make_consts
from avr_torch.train import state as tstate_lib

torch.set_num_threads(2)

ZERO_WEIGHTS = dict(energy_loss_weight=0.0, multistft_loss_weight=0.0)
# (name, world, data_parallel): data 2 × ray 1, data 1 × ray 2, and ray 3
# over R = 6·3 + 2 = 20 rays, padded to 21
CASES = [("data2", 2, 2), ("ray2", 2, 1), ("ray3", 3, 1)]


def _cfgs(logdir):
    jcfg = jax_cfg(logdir)
    for k, v in ZERO_WEIGHTS.items():
        setattr(jcfg.train, k, v)
    return jcfg, port_cfg(jcfg)


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    room = jsynth.RoomSpec(size=(4.0, 3.0, 2.5), max_order=2, fs=4000, seq_len=256)
    d = str(tmp_path_factory.mktemp("simu"))
    jsynth.write_simu_dataset(d, room, n=24)
    return d


@pytest.fixture(scope="module")
def setup(dataset_dir):
    """JAX's init, batch and directions, and the port's single-process step
    from them."""
    jcfg, cfg = _cfgs("/tmp/unused")
    data = load_dataset(dataset_dir, "Simu", eval=False, seq_len=256, fs=4000)
    batch = BatchSampler(data, 4, shuffle=False).gather(np.arange(4))
    jfst = jfield.build_field(jcfg.model, "Simu")
    jstate = jstate_lib.init_state(jax.random.PRNGKey(0), jfst, jcfg.train)
    key = jax.random.PRNGKey(42)
    dirs = np.array(jgeo.ray_directions(jcfg.render.n_azi, jcfg.render.n_ele, key=key))
    params = params_from_jax(jax.device_get(jstate.params), device="cpu")
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    fst = field.build_field(cfg.model, "Simu")
    consts = make_consts(cfg.render, 256, device="cpu")
    crit = CriterionConfig.from_configs(cfg.train, cfg.render)
    step, _ = tstate_lib.make_train_step(fst, consts, cfg.render, cfg.train, crit)
    state = tstate_lib.init_state(None, fst, cfg.train, device="cpu", params=tstate_lib.tree_map(torch.clone, params))
    single, bundle = step(state, tbatch, torch.from_numpy(dirs))
    return dict(jcfg=jcfg, cfg=cfg, batch=batch, tbatch=tbatch, dirs=dirs, key=key, params=params,
                jparams=jax.device_get(jstate.params), single=params_to_numpy(single.params),
                single_total=float(bundle.total), grads=single_process_grads(cfg, params, tbatch, dirs))


def single_process_grads(cfg, params, batch, dirs):
    """The port's single-process gradients of the loss (leaves in tree
    order), and the render function."""
    fst = field.build_field(cfg.model, "Simu")
    consts = make_consts(cfg.render, 256, device="cpu")
    crit = CriterionConfig.from_configs(cfg.train, cfg.render)
    _, render = tstate_lib.make_train_step(fst, consts, cfg.render, cfg.train, crit)
    params = tstate_lib.tree_map(lambda t: t.clone().requires_grad_(True), params)
    named = list(tstate_lib.named_leaves(params))
    pred = render(params, batch, torch.from_numpy(dirs))
    total = criterion(pred, batch["wave"], crit)[0].total
    grads = torch.autograd.grad(total, [t for _, t in named], allow_unused=True)
    return dict(pred=pred.detach(), total=float(total.detach()),
                grads=[torch.zeros_like(t) if g is None else g for (_, t), g in zip(named, grads)],
                names=[n for n, _ in named])


@pytest.fixture(scope="module")
def plan_ranks(setup, tmp_path_factory):
    """Each case's ranks (``torch_ranks.step_job``), spawned once for the
    module: case name → every rank's output."""
    cache = {}

    def get(name, world, data_parallel):
        if name not in cache:
            s = setup
            cache[name] = spawn(tmp_path_factory.mktemp(name), world, job="step", cfg=s["cfg"],
                                data_parallel=data_parallel, params=s["params"], batch=s["tbatch"],
                                dirs=torch.from_numpy(s["dirs"]))
        return cache[name]

    return get


def spawn(tmp_path, world, **job):
    """Run ``job`` on ``world`` ranks; returns each rank's output."""
    payload = str(tmp_path / "payload.pt")
    torch.save(job, payload)
    mp.spawn(torch_ranks.run, args=(world, str(tmp_path / "rdv"), payload, str(tmp_path)), nprocs=world)
    return [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(world)]


def jax_mesh_step(s, world, data_parallel):
    """JAX's mesh step on ``world`` virtual CPU devices."""
    jcfg = s["jcfg"]
    plan = jmake_mesh_plan(jax.devices()[:world], batch_size=4, data_parallel=data_parallel)
    fst = jfield.build_field(jcfg.model, "Simu")
    consts = jmake_consts(jcfg.render, 256)
    crit = JCrit.from_configs(jcfg.train, jcfg.render)
    step, _ = jstate_lib.make_train_step(fst, consts, jcfg.render, jcfg.train, crit, plan)
    jp = jax.tree_util.tree_map(jnp.asarray, s["jparams"])
    state = jstate_lib.TrainState(jp, jstate_lib.make_optimizer(jcfg.train).init(jp), jnp.zeros((), jnp.int32))
    state, bundle = step(state, plan.shard_batch(s["batch"]), s["key"])
    return (plan.n_data, plan.n_ray), jax.device_get(bundle), jax.device_get(state.params)


def assert_params_close(got, want):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def assert_step_close_to_jax(got, want, before, grads, lr):
    """One Adam step's params against JAX's (module docstring)."""
    g, w, p0 = (jax.tree_util.tree_leaves(t) for t in (got, want, before))
    u = [x.numpy().astype(np.float64) for x in grads]
    assert len(g) == len(w) == len(p0) == len(u)
    clip = min(1.0, 1.0 / np.sqrt(sum(np.sum(x ** 2) for x in u)))
    n_sure = n_moved = 0
    for a, b, pb, x in zip(g, w, p0, u):
        assert np.all(np.abs(a - pb) <= lr * (1 + 1e-3) + 1e-7)  # Adam's bound
        u_abs = np.abs(x) * clip
        np.testing.assert_array_equal(a[u_abs == 0], b[u_abs == 0])
        sure = u_abs > 1e-3 * u_abs.max()
        n_sure, n_moved = n_sure + int(sure.sum()), n_moved + int((u_abs > 0).sum())
        us = u_abs[sure]
        tol = 1e-6 + 1e-4 * np.abs(b[sure]) + lr * 1e-8 * 1e-3 * us / (us + 1e-8) ** 2
        assert np.all(np.abs(a[sure] - b[sure]) <= tol)
    assert n_sure > 0.7 * n_moved, (n_sure, n_moved)  # the tight tolerance covers most moved entries


@pytest.mark.parametrize("name,world,data_parallel", CASES, ids=[c[0] for c in CASES])
def test_plan_step_matches_single_process_and_jax_mesh(setup, plan_ranks, name, world, data_parallel):
    s = setup
    ranks = plan_ranks(name, world, data_parallel)
    n_ray = world // data_parallel
    assert [r["plan"] for r in ranks] == [(data_parallel, n_ray, k) for k in range(world)]
    for r in ranks:
        assert r["step"] == 1
        assert jax.tree_util.tree_structure(r["params"]) == jax.tree_util.tree_structure(ranks[0]["params"])
        for a, b in zip(jax.tree_util.tree_leaves(r["params"]), jax.tree_util.tree_leaves(ranks[0]["params"])):
            np.testing.assert_array_equal(a, b)  # the replicated state stays bit-identical
    got = ranks[0]
    # against the port's single-process step
    np.testing.assert_allclose(got["total"], s["single_total"], rtol=1e-5)
    assert_params_close(got["params"], s["single"])
    # against JAX's mesh step of the same factoring
    shape, jbundle, jparams = jax_mesh_step(s, world, data_parallel)
    assert shape == (data_parallel, n_ray)
    np.testing.assert_allclose(got["total"], float(jbundle.total), rtol=1e-5)
    assert_step_close_to_jax(got["params"], jparams, s["jparams"], s["grads"]["grads"], s["cfg"].train.lr)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("batch_size", [1, 4, 8])
def test_make_mesh_plan_factors_as_jax(world, batch_size):
    want = jmake_mesh_plan(jax.devices()[:world], batch_size=batch_size)
    got = mesh.make_mesh_plan(world=world, batch_size=batch_size, rank=world - 1)
    assert (got.n_data, got.n_ray) == (want.n_data, want.n_ray)
    assert (got.data_index, got.ray_index) == ((world - 1) // got.n_ray, (world - 1) % got.n_ray)


def test_make_mesh_plan_refuses_an_uneven_data_axis():
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh_plan(world=6, data_parallel=4, rank=0)
    with pytest.raises(ValueError, match="does not split"):
        mesh.make_mesh_plan(world=4, data_parallel=4, rank=0).rows(6)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh_plan(batch_size=4)


def test_shard_rays_pads_with_zero_weight_rays():
    dirs = torch.arange(20 * 3, dtype=torch.float32).reshape(20, 3)
    parts = [mesh.MeshPlan(1, 3, r).shard_rays(dirs) for r in range(3)]
    got = torch.cat([d for d, _ in parts])
    weights = torch.cat([w for _, w in parts])
    assert got.shape == (21, 3) and torch.equal(got[:20], dirs) and torch.equal(got[20], dirs[0])
    assert torch.equal(weights, torch.cat([torch.ones(20), torch.zeros(1)]))
    assert mesh.MeshPlan(1, 2, 1).shard_rays(dirs)[1] is None  # 2 divides 20
    assert mesh.MeshPlan(2, 1, 1).shard_rays(dirs) == (dirs, None)


@pytest.mark.parametrize("name,world,data_parallel", CASES, ids=[c[0] for c in CASES])
def test_prediction_backward_runs_no_collective_and_gradients_are_summed(setup, plan_ranks, name, world,
                                                                          data_parallel):
    """The forward's one all-reduce assembles the prediction, the backward
    runs none, and the gradient all-reduce sums the ranks' shares into the
    single-process gradient, not their mean (Adam's update hides a scale
    of the gradient, so the step tests cannot tell)."""
    s = setup
    ranks = plan_ranks(name, world, data_parallel)
    want = s["grads"]
    for r in ranks:
        assert r["calls"].count("forward") == 1 and "backward" not in r["calls"]
        assert r["calls"].count("gradients") >= 1
        torch.testing.assert_close(r["pred"], want["pred"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r["grad_total"], want["total"], rtol=1e-5)
    for n, g in zip(want["names"], want["grads"]):
        # each rank's share is not the whole; their sum is
        torch.testing.assert_close(sum(r["local"][n] for r in ranks), ranks[0]["summed"][n])
        assert all(torch.equal(r["summed"][n], ranks[0]["summed"][n]) for r in ranks)
        # the render parity tests' gradient tolerance, 1e-4 of the leaf's scale
        scale = float(g.abs().max())
        torch.testing.assert_close(ranks[0]["summed"][n], g, rtol=1e-4, atol=1e-4 * max(scale, 1e-12))


def test_population_with_a_plan_raises(setup):
    cfg = setup["cfg"]
    tc = port_cfg(setup["jcfg"], runtime_hparams=True).train
    fst = field.build_field(cfg.model, "Simu")
    with pytest.raises(ValueError, match="single-device"):
        tstate_lib.make_train_step(fst, make_consts(cfg.render, 256, device="cpu"), cfg.render, tc,
                                   CriterionConfig(), population=2, mesh_plan=mesh.MeshPlan(1, 2, 0))


@pytest.mark.parametrize("env", ["complete", "incomplete"])
def test_initialize_multihost_refuses_nccl_ranks_sharing_a_device(monkeypatch, env):
    """An NCCL rank must own cuda:{LOCAL_RANK}; two ranks on one device
    raise before any process group is made, as does an incomplete torchrun
    environment."""
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    if env == "incomplete":
        monkeypatch.delenv("MASTER_PORT")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **k: pytest.fail("joined"))
    match = "needs its own device" if env == "complete" else "lacks"
    for device in ("cuda:0", "cuda"):  # cuda means cuda:1 here, which does not exist
        with pytest.raises(RuntimeError, match=match):
            mesh.initialize_multihost(device, "nccl")


def test_initialize_multihost_deals_gloo_ranks_round_the_devices(monkeypatch):
    """Gloo on CUDA lets ranks share a device: a bare ``cuda`` is
    ``cuda:{LOCAL_RANK % device_count}`` (local rank 1 of a one-card host
    gets cuda:0), ``cuda:i`` is taken as given, and a device the host lacks
    raises before any process group is made."""
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    current, joined = [], []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: joined.append((backend, kw["rank"], kw["world_size"])))
    assert mesh.initialize_multihost("cuda", "gloo") == torch.device("cuda", 0)
    assert mesh.initialize_multihost("cuda:0", "gloo") == torch.device("cuda", 0)
    assert current == [torch.device("cuda", 0)] * 2 and joined == [("gloo", 1, 2)] * 2
    with pytest.raises(RuntimeError, match="the host has 1"):
        mesh.initialize_multihost("cuda:1", "gloo")
    assert len(joined) == 2


def test_runner_under_a_plan_matches_the_single_process_runner(tmp_path, setup, dataset_dir):
    """``AVRRunner.train`` on 2 ranks (data 2) for 1 iteration, with a
    log, a checkpoint and a validation at 1: every rank ends on the same params,
    within the tolerances of the single-process runner's; rank 0 alone
    writes (one metrics line per tag and step, one config backup, one
    checkpoint directory per step); the padded validation render of the
    test split matches the single-process runner's."""
    from avr_torch.train.runner import AVRRunner

    def cfg(logdir):
        return port_cfg(setup["jcfg"], logdir=str(logdir), total_iterations=1, save_freq=1, val_freq=1,
                        log_freq=1)

    single = AVRRunner(cfg(tmp_path / "single"), dataset_dir, device="cpu")
    single.train()
    assert len(single.test_data) % 4, "the test split should end in a partial batch"
    want_pred, _ = single.render_dataset(single.test_data, dirs=setup["dirs"])
    ranks = spawn(tmp_path, 2, job="runner", cfg=cfg(tmp_path / "plan"), data_parallel=2,
                  dataset_dir=dataset_dir, dirs=setup["dirs"])
    for r in ranks:
        assert r["step"] == 1 and r["latest"] == 1
        for a, b in zip(jax.tree_util.tree_leaves(r["params"]), jax.tree_util.tree_leaves(ranks[0]["params"])):
            np.testing.assert_array_equal(a, b)
        # the render parity tests' forward tolerance, 5e-5 of the scale
        np.testing.assert_allclose(r["pred"], want_pred, rtol=1e-4, atol=5e-5 * np.abs(want_pred).max())
    assert_params_close(ranks[0]["params"], params_to_numpy(single.state.params))
    logdir = tmp_path / "plan" / "tiny"
    lines = [tuple(sorted(json.loads(l).items())) for l in open(logdir / "metrics.jsonl")]
    keys = [(dict(l)["tag"], dict(l)["step"]) for l in lines]
    assert keys and len(keys) == len(set(keys))
    assert sorted(keys) == sorted((json.loads(l)["tag"], json.loads(l)["step"])
                                  for l in open(tmp_path / "single" / "tiny" / "metrics.jsonl"))
    assert open(logdir / "command_log.txt").read().count("\n") == 1
    assert sorted(os.listdir(logdir / "ckpts")) == ["1"]
    assert sorted(os.listdir(logdir / "val_result")) == ["val_iter000001.npz"]


def test_buckets_hold_every_tensor_in_its_shape(monkeypatch):
    """The flat buckets of the gradient all-reduce and the state broadcast:
    tensors grouped by dtype, split where a bucket would pass BUCKET_BYTES
    (one tensor larger than that gets its own), each result in its
    tensor's shape and position."""
    monkeypatch.setattr(mesh, "BUCKET_BYTES", 64)
    gen = torch.Generator().manual_seed(0)
    tensors = [torch.randn((3, 2), generator=gen), torch.randint(0, 9, (5,), dtype=torch.int32),
               torch.randn((40,), generator=gen), torch.randn((2, 2, 2), generator=gen), torch.tensor(7)]
    sizes = []

    def collective(buf):
        sizes.append((buf.dtype, buf.numel()))
        buf.mul_(2)

    out = mesh._bucketed(tensors, collective)
    assert sizes == [(torch.float32, 6), (torch.float32, 40), (torch.float32, 8), (torch.int32, 5),
                     (torch.int64, 1)]
    for t, o in zip(tensors, out):
        assert o.shape == t.shape and o.dtype == t.dtype and torch.equal(o, t * 2)
