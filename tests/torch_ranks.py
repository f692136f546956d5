"""Rank processes of tests/test_torch_parallel.py: spawned with
``torch.multiprocessing``, joined through a gloo process group on the CPU
(file rendezvous), one thread each. Imports torch and avr_torch only.

Each rank reads the job's inputs from a ``torch.save`` payload written by
the test and writes what it computed to ``{out_dir}/rank{r}.pt``.
"""

import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, rdv: str, payload_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=world, rank=rank)
    try:
        job = torch.load(payload_path, weights_only=False)
        out = JOBS[job["job"]](job)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _setup(job):
    from avr_torch.losses import CriterionConfig
    from avr_torch.models import field
    from avr_torch.parallel.mesh import make_mesh_plan
    from avr_torch.render.common import make_consts

    cfg = job["cfg"]
    fst = field.build_field(cfg.model, cfg.path.dataset_type)
    consts = make_consts(cfg.render, cfg.model.signal_output_dim, device="cpu")
    crit = CriterionConfig.from_configs(cfg.train, cfg.render)
    plan = make_mesh_plan(batch_size=cfg.train.batch_size, data_parallel=job["data_parallel"])
    return cfg, fst, consts, crit, plan


def step_job(job):
    """The plan's gradients of the payload's loss, with every ``all_reduce``
    counted by phase, then one plan step from the payload's params on its
    batch and directions."""
    from avr_torch.convert import params_to_numpy
    from avr_torch.losses import criterion
    from avr_torch.parallel.mesh import all_reduce_sum
    from avr_torch.train.state import broadcast_state, init_state, make_train_step, named_leaves, tree_map

    cfg, fst, consts, crit, plan = _setup(job)
    step, render = make_train_step(fst, consts, cfg.render, cfg.train, crit, mesh_plan=plan)
    calls = []
    real = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls.append(phase)
        return real(tensor, *args, **kwargs)

    dist.all_reduce = counted
    try:
        params = tree_map(lambda t: t.clone().requires_grad_(True), job["params"])
        named = list(named_leaves(params))
        phase = "forward"
        pred = render(params, job["batch"], job["dirs"])
        total = criterion(pred, job["batch"]["wave"], crit)[0].total
        phase = "backward"
        local = torch.autograd.grad(total, [t for _, t in named], allow_unused=True)
        local = [torch.zeros_like(t) if g is None else g for (_, t), g in zip(named, local)]
        phase = "gradients"
        summed = all_reduce_sum(local)
    finally:
        dist.all_reduce = real

    state = init_state(None, fst, cfg.train, device="cpu", params=job["params"])
    state = broadcast_state(state)
    state, bundle = step(state, job["batch"], job["dirs"])
    return {"plan": (plan.n_data, plan.n_ray, plan.rank), "total": float(bundle.total),
            "params": params_to_numpy(state.params), "step": int(state.step),
            "calls": calls, "pred": pred.detach(), "grad_total": float(total.detach()),
            "local": {n: g for (n, _), g in zip(named, local)},
            "summed": {n: g for (n, _), g in zip(named, summed)}}


def runner_job(job):
    """``AVRRunner.train`` under the plan; the final state and the rank's
    validation render of the test split."""
    from avr_torch.convert import params_to_numpy
    from avr_torch.train.runner import AVRRunner

    cfg, _, _, _, plan = _setup(job)
    runner = AVRRunner(cfg, job["dataset_dir"], device="cpu", mesh_plan=plan)
    runner.train()
    pred, _ = runner.render_dataset(runner.test_data, dirs=job["dirs"])
    runner.writer.close()
    return {"params": params_to_numpy(runner.state.params), "step": int(runner.state.step), "pred": pred,
            "latest": runner.latest_step()}


JOBS = {"step": step_job, "runner": runner_job}
