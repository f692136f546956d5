"""Native hyper-parameter optimization engine (Optuna-compatible surface).

A copy of ``avr_tpu/hpo/study.py`` (stdlib only), with one repair: trials
numbered by ``optimize`` also count past the numbers ``ask`` has handed out,
so mixing the two in one process cannot give two trials one number.

The reference drives HPO through Optuna with SQLite-backed resumable
studies (reference/optuna_avr_runner.py:141-164). Optuna is not available
in this image, so this module provides a self-contained engine with the
same core surface — ``create_study(study_name, storage, direction,
load_if_exists)``, ``study.optimize(objective, n_trials)``,
``trial.suggest_float/int/categorical`` — persisted to SQLite via the
stdlib, using an independent one-dimensional TPE sampler (random sampling
for the first ``n_startup`` trials, then candidates drawn from a KDE over
the best-γ quantile scored by the good/bad density ratio — the same
strategy class as Optuna's default TPESampler).

If the real Optuna is installed it can be used instead; the call sites
only rely on this shared surface.
"""

from __future__ import annotations

import json
import math
import os
import random
import sqlite3
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence


@dataclass
class ParamSpec:
    kind: str  # "float" | "int" | "categorical"
    low: float = 0.0
    high: float = 1.0
    log: bool = False
    choices: Optional[Sequence[Any]] = None


class Trial:
    def __init__(self, study: "Study", number: int,
                 queued: Optional[Dict[str, Any]] = None):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        # enqueue_trial payload: fixed values served instead of sampling
        self._queued = queued or {}

    # -- suggest API ---------------------------------------------------
    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        if name in self._queued:
            v = min(max(float(self._queued[name]), low), high)
        else:
            v = self.study._sample(name, ParamSpec("float", low, high, log))
        self.params[name] = float(v)
        return float(v)

    def suggest_int(self, name: str, low: int, high: int) -> int:
        if name in self._queued:
            v = min(max(int(self._queued[name]), low), high)
        else:
            v = self.study._sample(name, ParamSpec("int", low, high))
        self.params[name] = int(v)
        return int(v)

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        if name in self._queued and self._queued[name] in choices:
            v = self._queued[name]
        else:
            v = self.study._sample(
                name, ParamSpec("categorical", choices=list(choices))
            )
        self.params[name] = v
        return v


class Study:
    def __init__(
        self,
        study_name: str,
        storage: Optional[str] = None,
        direction: str = "minimize",
        seed: int = 0,
        n_startup: int = 10,
        gamma: float = 0.25,
    ):
        assert direction in ("minimize", "maximize")
        self.study_name = study_name
        self.direction = direction
        self.n_startup = n_startup
        self.gamma = gamma
        self._rng = random.Random(seed)
        self._db: Optional[sqlite3.Connection] = None
        if storage:
            path = storage.replace("sqlite:///", "")
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._db = sqlite3.connect(path)
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS trials ("
                "study TEXT, number INTEGER, state TEXT, value REAL, "
                "params TEXT, ts REAL)"
            )
            self._db.commit()
        self._mem_trials: List[Dict[str, Any]] = []
        self._max_pending = -1  # highest number handed out by ask()
        self._queue: List[Dict[str, Any]] = []  # enqueue_trial payloads

    # -- storage -------------------------------------------------------
    def _completed(self) -> List[Dict[str, Any]]:
        if self._db is not None:
            rows = self._db.execute(
                "SELECT number, value, params FROM trials "
                "WHERE study=? AND state='COMPLETE' ORDER BY number",
                (self.study_name,),
            ).fetchall()
            return [
                {"number": n, "value": v, "params": json.loads(p)} for n, v, p in rows
            ]
        return [t for t in self._mem_trials if t.get("state") == "COMPLETE"]

    def _max_number(self) -> int:
        """Highest trial number in ANY state (COMPLETE or FAIL), so a
        resumed study never reuses a failed trial's number."""
        if self._db is not None:
            row = self._db.execute(
                "SELECT MAX(number) FROM trials WHERE study=?",
                (self.study_name,),
            ).fetchone()
            return -1 if row is None or row[0] is None else int(row[0])
        return max((t["number"] for t in self._mem_trials), default=-1)

    def _record(self, number: int, state: str, value: Optional[float], params: Dict):
        if self._db is not None:
            self._db.execute(
                "INSERT INTO trials VALUES (?,?,?,?,?,?)",
                (self.study_name, number, state, value, json.dumps(params), time.time()),
            )
            self._db.commit()
        else:
            self._mem_trials.append(
                {"number": number, "state": state, "value": value, "params": params}
            )

    @property
    def trials(self) -> List[Dict[str, Any]]:
        return self._completed()

    @property
    def best_trial(self) -> Dict[str, Any]:
        done = self._completed()
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t["value"]) if self.direction == "minimize" else (lambda t: -t["value"])
        return min(done, key=key)

    @property
    def best_value(self) -> float:
        return self.best_trial["value"]

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial["params"]

    # -- sampling ------------------------------------------------------
    def _to_unit(self, spec: ParamSpec, v: float) -> float:
        if spec.log:
            return (math.log(v) - math.log(spec.low)) / (
                math.log(spec.high) - math.log(spec.low)
            )
        return (v - spec.low) / (spec.high - spec.low)

    def _from_unit(self, spec: ParamSpec, u: float) -> float:
        u = min(max(u, 0.0), 1.0)
        if spec.log:
            return math.exp(
                math.log(spec.low) + u * (math.log(spec.high) - math.log(spec.low))
            )
        return spec.low + u * (spec.high - spec.low)

    def _sample(self, name: str, spec: ParamSpec):
        history = [
            (t["params"][name], t["value"])
            for t in self._completed()
            if name in t["params"]
        ]
        if spec.kind == "categorical":
            return self._sample_categorical(spec, history)
        if len(history) < self.n_startup:
            u = self._rng.random()
            v = self._from_unit(spec, u)
            return round(v) if spec.kind == "int" else v
        return self._sample_tpe(spec, history)

    def _sample_categorical(self, spec: ParamSpec, history):
        if len(history) < self.n_startup:
            return self._rng.choice(spec.choices)
        sign = 1.0 if self.direction == "minimize" else -1.0
        ranked = sorted(history, key=lambda h: sign * h[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [h[0] for h in ranked[:n_good]]
        # probability ∝ (1 + count in good set), softened
        weights = [1.0 + sum(1 for g in good if g == c) for c in spec.choices]
        total = sum(weights)
        r = self._rng.random() * total
        acc = 0.0
        for c, w in zip(spec.choices, weights):
            acc += w
            if r <= acc:
                return c
        return spec.choices[-1]

    def _sample_tpe(self, spec: ParamSpec, history, n_candidates: int = 24):
        sign = 1.0 if self.direction == "minimize" else -1.0
        ranked = sorted(history, key=lambda h: sign * h[1])
        n_good = max(1, int(len(ranked) * self.gamma))
        good = [self._to_unit(spec, h[0]) for h in ranked[:n_good]]
        bad = [self._to_unit(spec, h[0]) for h in ranked[n_good:]] or [0.5]
        bw = max(0.08, 1.0 / max(len(good), 1))

        def kde(xs, x):
            return sum(
                math.exp(-0.5 * ((x - m) / bw) ** 2) for m in xs
            ) / (len(xs) * bw) + 1e-12

        best_u, best_score = None, -1.0
        for _ in range(n_candidates):
            mean = self._rng.choice(good)
            u = min(max(self._rng.gauss(mean, bw), 0.0), 1.0)
            score = kde(good, u) / kde(bad, u)
            if score > best_score:
                best_u, best_score = u, score
        v = self._from_unit(spec, best_u)
        return round(v) if spec.kind == "int" else v

    # -- ask/tell ------------------------------------------------------
    def enqueue_trial(self, params: Dict[str, Any]) -> None:
        """Queue fixed parameter values for the next asked/optimized
        trial (Optuna's ``enqueue_trial``): suggest_* serves the queued
        value (clamped to the spec's range) instead of sampling. Used to
        seed a study with a known-good configuration."""
        self._queue.append(dict(params))

    def ask(self) -> Trial:
        """Sample a new trial without running it (Optuna's batched
        ``study.ask()`` surface). Numbers account for pending asked
        trials so a population batch gets K distinct numbers; sampling
        uses the completed history only, so the K draws of one batch
        come from the same TPE posterior (the standard synchronous-batch
        relaxation — candidate draws are stochastic, so the batch stays
        diverse)."""
        number = max(self._max_number(), self._max_pending) + 1
        self._max_pending = number
        queued = self._queue.pop(0) if self._queue else None
        return Trial(self, number, queued=queued)

    def tell(self, trial: Trial, value: Optional[float],
             state: str = "COMPLETE") -> None:
        """Record an asked trial's outcome (value=None + state='FAIL'
        for a crashed trial)."""
        self._record(
            trial.number, state,
            None if value is None else float(value), trial.params,
        )

    # -- driver --------------------------------------------------------
    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int,
        catch: tuple = (),
    ) -> None:
        """Run `n_trials` trials. Exceptions of a type in `catch` record
        the trial as FAIL and continue (Optuna's `Study.optimize(catch=)`
        semantics); other exceptions propagate after being recorded.
        Numbers continue past those already asked (``ask``) but not told."""
        start = max(self._max_number(), self._max_pending) + 1
        for i in range(n_trials):
            trial = Trial(
                self, start + i,
                queued=self._queue.pop(0) if self._queue else None,
            )
            self._max_pending = trial.number
            try:
                value = float(objective(trial))
            except Exception as e:
                self._record(
                    trial.number, "FAIL", None,
                    {**trial.params, "__error__": f"{type(e).__name__}: {e}"},
                )
                if isinstance(e, catch):
                    continue
                raise
            self._record(trial.number, "COMPLETE", value, trial.params)


def create_study(
    study_name: str,
    storage: Optional[str] = None,
    direction: str = "minimize",
    load_if_exists: bool = True,
    seed: int = 0,
) -> Study:
    """Optuna-style factory; an existing SQLite study resumes
    automatically (load_if_exists is accepted for API parity — resuming
    is always safe because trials are append-only)."""
    del load_if_exists
    return Study(study_name, storage, direction, seed=seed)
