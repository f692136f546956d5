"""Render cells: the ``render`` that ``make_train_step`` returns, under
``torch.inference_mode``, in a closed loop with one client.

Each request is one pose of the traffic's pool (taken in turn): a batch of
the rows of one microphone group at a new place. Every request uses the
one set of evaluation directions drawn from the seed. A request's time
runs from the host's call to the synchronised spectrum.

Number compared: ``spectrum_gap``, over a sample of the window's requests
drawn from the seed, the largest ‖program − reference‖ / ‖reference‖ of a
request's spectra.
"""

from __future__ import annotations

import gc
from typing import Dict

import torch

from benchmark import counts, inputs, weights
from benchmark.reference import Reference
from benchmark.reference.field import Field
from benchmark.reference.precision import FP32


class Session:
    kind = "render"

    def __init__(self, cfg_dict: dict, traffic: dict, seed: int, device):
        from avr_torch.config import AVRConfig
        from avr_torch.losses import CriterionConfig
        from avr_torch.models import field
        from avr_torch.render.common import make_consts
        from avr_torch.train import state as st

        self.device, self.seed, self.cfg_dict, self.traffic = device, seed, cfg_dict, traffic
        cfg = AVRConfig.from_dict(cfg_dict)
        self.rc, tc = cfg.render, cfg.train
        self.fld = Field(cfg_dict)
        fst = field.build_field(cfg.model, cfg.path.dataset_type)
        consts = make_consts(self.rc, cfg.model.signal_output_dim, device=device)
        _, self.render = st.make_train_step(fst, consts, self.rc, tc, CriterionConfig.from_configs(tc, self.rc))
        drawn = weights.draw(self.fld, inputs.torch_generator(seed, 0, device), device)
        self.w0 = {n: t.to("cpu") for n, t in drawn.items()}
        self.params = weights.program_tree(drawn, self.fld)
        del drawn
        self.poses = inputs.render_poses(cfg_dict, traffic["requests"], seed, device)
        self.poses["ch_idx"] = self.poses["ch_idx"].long()
        self.n_poses = self.poses["pos_rx"].shape[0]
        self.dirs = inputs.ray_directions(self.rc.n_azi, self.rc.n_ele, inputs.torch_generator(seed, 5, device), device)
        self.points = self.poses["pos_rx"].shape[1] * self.rc.n_rays * self.rc.n_samples
        self.next = 0
        self.outputs: Dict[int, torch.Tensor] = {}

    def request(self, i: int) -> torch.Tensor:
        batch = {k: v[i % self.n_poses] for k, v in self.poses.items()}
        with torch.inference_mode():
            return self.render(self.params, batch, self.dirs)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        for _ in range(int(self.traffic["warmup_requests"])):
            self.request(self.next)
            self.next += 1
        self._sync()

    def window(self, seconds: float, clock) -> dict:
        lat = []
        t0 = clock()
        while True:
            t = clock()
            self.outputs[self.next] = self.request(self.next)
            self._sync()
            lat.append(clock() - t)
            self.next += 1
            if clock() - t0 >= seconds:
                break
        elapsed = clock() - t0
        outs = torch.stack(list(self.outputs.values()))
        failed = int((~torch.isfinite(outs.flatten(1)).all(dim=1)).sum())
        return {"seconds": elapsed, "calls": len(lat), "attempted": len(lat), "failed": failed,
                "latencies_s": lat, "trials_per_call": 1}

    def traced_call(self, i: int) -> None:
        self.request(self.next)
        self.next += 1

    def work(self) -> dict:
        return {"model_flops_per_call": counts.model_flops(self.fld, self.points, 0, backward=False)}

    def release(self) -> None:
        del self.params, self.render
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        keys = sorted(self.outputs)
        n = min(int(self.traffic["checked_requests"]), len(keys))
        pick = inputs.rng(self.seed, 6).choice(len(keys), size=n, replace=False)
        return [keys[j] for j in sorted(pick)]

    def reference_readings(self, precision: str = FP32) -> Dict[int, torch.Tensor]:
        """The reference's spectra of the sampled requests."""
        ref = Reference(self.cfg_dict, self.device, precision, ray_block=max(1, 2 ** 17 // (self.points // self.rc.n_rays)))
        w = {n: v.to(self.device) for n, v in self.w0.items()}
        return {i: ref.render(w, {k: v[i % self.n_poses] for k, v in self.poses.items()}, self.dirs)
                for i in self.sample()}

    def check(self, names=("spectrum_gap",)) -> Dict[str, float]:
        want = self.reference_readings()
        return numbers({i: self.outputs[i] for i in want}, want)


def numbers(got: Dict[int, torch.Tensor], want: Dict[int, torch.Tensor]) -> Dict[str, float]:
    gaps = [float(torch.linalg.vector_norm(got[i].float() - w) / torch.linalg.vector_norm(w)) for i, w in want.items()]
    return {"spectrum_gap": next((g for g in gaps if g != g), max(gaps))}  # a NaN stays
