"""Bayesian optimization with multi-dimensional epsilon-greedy search

A copy of ``repro.core.bo`` (numpy only): the port imports
nothing of the reference package.

(paper §IV-B, Alg. 2).

The black box maps Q key-value-table adjustments -> billed cost of all MoE
layers (via prediction -> ODS deployment -> serverless simulation). A
Gaussian-process surrogate (RBF kernel over the Q-dim value vector) ranks
exploration candidates; the acquisition is a decaying PER-DIMENSION
epsilon-greedy: dims 1..muQ explore inside the feedback-limited range L
(token IDs whose prediction error exceeded alpha), dims muQ+1..Q explore
the full range P (any token-to-expert mapping), and the decay of
eps_{1:muQ} is slowed by (1+rho'*tau) with rho' in {rho1, rho2, rho3}
per the feedback case (memory overrun / payload violation / feasible).

Alternative acquisitions reproduce the paper's Fig. 13 comparison:
``random``, ``single_eps``, ``tpe`` (per-dimension categorical TPE over the
good/bad history split — a simplification of Bergstra et al.'s kernel TPE,
documented here), and ``multi_eps`` (ours).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.table import KVTable, pack_key, unpack_key


@dataclass
class EvalOutcome:
    """What one BO trial observes (lines 8-28 of Alg. 2)."""

    cost: float                         # c_tau (mean over J batches)
    rho_case: int                       # 1 mem-overrun, 2 payload, 3 feasible
    problem_token_ids: np.ndarray       # f1' appended to L_tau (line 12)
    demand_pred: np.ndarray             # (L, E)
    demand_real: np.ndarray             # (L, E)
    aux: Dict = field(default_factory=dict)


@dataclass
class Trial:
    keys: np.ndarray       # (Q,) int64 packed z_q
    values: np.ndarray     # (Q,) float v_q
    cost: float


@dataclass
class BOResult:
    best_table: KVTable
    best_cost: float
    history: List[Trial]
    costs: List[float]
    iterations: int
    converged: bool
    # warm-start carry-over (defaults keep pre-warm-start constructors
    # valid): the feedback-limited token range L accumulated over the
    # run, the per-dimension epsilon vector at termination, and how many
    # of ``history``'s trials were inherited from a resumed result
    limit_tokens: Optional[np.ndarray] = None
    final_eps: Optional[np.ndarray] = None
    seeded_trials: int = 0


# ---------------------------------------------------------------------------
# Gaussian-process surrogate
# ---------------------------------------------------------------------------

class GPSurrogate:
    """RBF-kernel GP regression over normalized trial value-vectors."""

    def __init__(self, length_scale: float = 1.0, noise: float = 1e-3):
        self.ls = length_scale
        self.noise = noise
        self._X: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._ymean = 0.0

    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls ** 2 * max(A.shape[1], 1)))

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GPSurrogate":
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        self._ymean = y.mean()
        K = self._kernel(X, X)
        resid = y - self._ymean
        # Cholesky with escalating jitter: near-duplicate trial vectors
        # (routine once warm-starting replays a prior window's history)
        # make the raw RBF kernel numerically singular, and a plain
        # np.linalg.solve dies with LinAlgError. The RBF kernel is PSD,
        # so K + jitter*I is PD for any jitter > 0 — escalate until the
        # factorization goes through.
        eye = np.eye(len(K))
        jitter = max(self.noise, 1e-12)
        for _ in range(8):
            try:
                L = np.linalg.cholesky(K + jitter * eye)
                break
            except np.linalg.LinAlgError:
                jitter *= 10.0
        else:        # pathological K: fall back to the least-squares fit
            self._alpha = np.linalg.lstsq(K + jitter * eye, resid,
                                          rcond=None)[0]
            self._X = X
            return self
        self._alpha = np.linalg.solve(
            L.T, np.linalg.solve(L, resid))
        self._X = X
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self._X is None:
            return np.zeros(len(X))
        return self._kernel(np.asarray(X, float), self._X) @ self._alpha \
            + self._ymean


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

class BOOptimizer:
    def __init__(
        self,
        base_table: KVTable,
        eval_fn: Callable[[KVTable], EvalOutcome],
        *,
        Q: int = 200,
        mu: float = 0.5,
        eps0: float = 0.6,
        rho: float = 0.5,
        rho1: float = 0.35,     # rho1 < rho  (memory overrun: slowest decay)
        rho2: float = 0.2,      # rho2 < rho1 (payload violation)
        rho3: float = 0.05,     # rho3 < rho2 (feasible)
        lam: int = 5,
        zeta: float = 1e-4,
        max_iters: int = 40,
        n_candidates: int = 8,
        acquisition: str = "multi_eps",
        seed: int = 0,
    ):
        assert rho1 < rho and rho2 < rho1 and rho3 < rho2
        self.base_table = base_table
        self.eval_fn = eval_fn
        self.Q, self.mu = Q, mu
        self.eps0 = np.full(Q, eps0)
        self.rho, self.rhos = rho, {1: rho1, 2: rho2, 3: rho3}
        self.lam, self.zeta = lam, zeta
        self.max_iters = max_iters
        self.n_candidates = n_candidates
        self.acquisition = acquisition
        self.rng = np.random.default_rng(seed)
        self.gp = GPSurrogate()

    # ----------------------------------------------------------- init/ranges
    def _init_variables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Seed the Q pairs with the highest-count profiled entries."""
        keys, vals = self.base_table.entries()
        if len(keys) == 0:
            z = np.zeros(self.Q, np.int64)
            return z, np.ones(self.Q)
        order = np.argsort(-vals)
        take = order[:self.Q]
        z = keys[take]
        v = vals[take]
        if len(z) < self.Q:
            pad = self.Q - len(z)
            z = np.concatenate([z, self.rng.choice(keys, pad)])
            v = np.concatenate([v, np.ones(pad)])
        return z, v.astype(float)

    def _sample_key(self, limit_tokens: Optional[np.ndarray]) -> int:
        t = self.base_table
        keys, _ = t.entries()
        layer = int(self.rng.integers(t.num_layers))
        expert = int(self.rng.integers(t.num_experts))
        if limit_tokens is not None and len(limit_tokens):
            f1 = int(self.rng.choice(limit_tokens))
        else:
            seen = np.nonzero(t.token_freq)[0]
            f1 = int(self.rng.choice(seen)) if len(seen) else \
                int(self.rng.integers(t.vocab_size))
        f2 = int(self.rng.integers(512))
        seen = np.nonzero(t.token_freq)[0]
        f3 = int(self.rng.choice(seen)) if len(seen) else f1
        return int(pack_key(layer, f1, f2, f3, expert))

    def _sample_value(self, current: float) -> float:
        scale = max(current, 1.0)
        return float(max(1.0, np.round(
            scale * np.exp(self.rng.normal(0, 0.7)))))

    # -------------------------------------------------------------- proposal
    def _propose(self, eps: np.ndarray, history: List[Trial],
                 limit_tokens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        best = min(history, key=lambda t: t.cost)
        muQ = int(self.mu * self.Q)
        if self.acquisition == "random":
            explore = np.ones(self.Q, bool)
        elif self.acquisition == "single_eps":
            e = float(eps.mean())
            explore = self.rng.random(self.Q) < e
        elif self.acquisition == "tpe":
            return self._propose_tpe(history, limit_tokens)
        else:   # multi_eps (ours)
            explore = self.rng.random(self.Q) < eps

        def one_candidate():
            z = best.keys.copy()
            v = best.values.copy()
            for q in np.nonzero(explore)[0]:
                lim = limit_tokens if q < muQ else None
                if self.rng.random() < 0.5 or q >= muQ:
                    z[q] = self._sample_key(lim)
                v[q] = self._sample_value(v[q])
            return z, v

        cands = [one_candidate() for _ in range(self.n_candidates)]
        if len(history) >= 3:
            X = np.stack([np.log1p(v) for _, v in cands])
            pred = self.gp.predict(X)
            z, v = cands[int(np.argmin(pred))]
        else:
            z, v = cands[0]
        return z, v

    def _propose_tpe(self, history, limit_tokens):
        """Per-dimension categorical TPE over the good/bad history split."""
        costs = np.array([t.cost for t in history])
        gamma = np.quantile(costs, 0.3)
        good = [t for t in history if t.cost <= gamma] or history[:1]
        bad = [t for t in history if t.cost > gamma] or history[:1]
        z = np.empty(self.Q, np.int64)
        v = np.empty(self.Q)
        for q in range(self.Q):
            gv = np.array([t.values[q] for t in good])
            bv = np.array([t.values[q] for t in bad])
            cands = np.concatenate([gv, [self._sample_value(gv.mean())]])
            # score l/g with gaussian kernels
            def dens(x, data):
                s = max(data.std(), 1.0)
                return np.exp(-0.5 * ((x[:, None] - data) / s) ** 2).mean(1)
            score = dens(cands, gv) / np.maximum(dens(cands, bv), 1e-9)
            pick = int(np.argmax(score))
            v[q] = cands[pick]
            zs = [t.keys[q] for t in good]
            z[q] = zs[self.rng.integers(len(zs))]
        return z, v

    # ------------------------------------------------------------------- run
    def run(self, resume_from: Optional[BOResult] = None, *,
            warm_start: Optional[Sequence[Trial]] = None,
            max_seed_trials: int = 32,
            eps_resume_floor: float = 0.05) -> BOResult:
        """One Alg. 2 search; optionally warm-started.

        ``resume_from`` (a prior :class:`BOResult`, e.g. the previous
        accounting window's search) seeds the GP surrogate and proposal
        ranking with the prior trial history, restores the
        feedback-limited token range L, carries the partially-decayed
        per-dimension epsilon schedule forward (floored at
        ``eps_resume_floor`` so exploration never fully dies across
        windows), and starts from the prior best table/cost — a
        warm-started run can therefore never END with a higher
        ``best_cost`` than its seed. ``warm_start`` alternatively seeds
        raw :class:`Trial` history without the epsilon/L carry-over.
        Only the ``max_seed_trials`` most recent seed trials are kept
        (plus the seed's best trial) so the O(n^3) GP fit stays bounded
        across long re-planning sequences. Convergence is judged on the
        running best INCLUDING the seed, so a window whose traffic
        barely moved converges after ``lam + 1`` trials instead of
        re-exploring from scratch.
        """
        seed_trials: List[Trial] = []
        if resume_from is not None and warm_start is not None:
            raise ValueError("pass resume_from or warm_start, not both")
        if resume_from is not None:
            seed_trials = list(resume_from.history)
        elif warm_start is not None:
            seed_trials = list(warm_start)
        for t in seed_trials:
            if len(t.keys) != self.Q or len(t.values) != self.Q:
                raise ValueError(
                    f"warm-start trial has Q={len(t.keys)} dims, "
                    f"optimizer has Q={self.Q}")
        if len(seed_trials) > max_seed_trials:
            best_seed = min(seed_trials, key=lambda t: t.cost)
            tail = seed_trials[-max_seed_trials:]
            if best_seed not in tail:
                tail = [best_seed] + tail[1:]
            seed_trials = tail

        history: List[Trial] = list(seed_trials)
        costs: List[float] = []
        best_cost = np.inf
        best_table = self.base_table.copy()
        limit_tokens = np.zeros(0, np.int64)
        eps0 = self.eps0
        converged = False
        if resume_from is not None:
            best_cost = float(resume_from.best_cost)
            best_table = resume_from.best_table.copy()
            if resume_from.limit_tokens is not None:
                limit_tokens = np.asarray(resume_from.limit_tokens,
                                          np.int64).copy()
            if resume_from.final_eps is not None \
                    and len(resume_from.final_eps) == self.Q:
                eps0 = np.clip(np.asarray(resume_from.final_eps, float),
                               eps_resume_floor, 1.0)
        elif seed_trials:
            best_seed = min(seed_trials, key=lambda t: t.cost)
            best_cost = float(best_seed.cost)
            best_table = self.base_table.copy()
            for zq, vq in zip(best_seed.keys.tolist(),
                              best_seed.values.tolist()):
                best_table.counts[int(zq)] = float(vq)

        if seed_trials:
            # the GP and proposal ranking see the seed immediately: the
            # very first trial of this window is already history-guided
            if len(history) >= 3:
                X = np.stack([np.log1p(t.values) for t in history])
                y = np.array([t.cost for t in history])
                self.gp.fit(X, y)
            z, v = self._propose(np.clip(eps0, 0.0, 1.0), history,
                                 limit_tokens)
        else:
            z, v = self._init_variables()
        # running best including any seed: identical to min(costs[:i+1])
        # on a cold start, and the convergence signal a warm start needs
        run_min: List[float] = []
        eps = np.clip(eps0, 0.0, 1.0)

        for tau in range(1, self.max_iters + 1):
            eps = eps0 / (1 + self.rho * tau)                 # line 3
            table = self.base_table.copy()                    # line 4
            for zq, vq in zip(z.tolist(), v.tolist()):
                table.counts[int(zq)] = float(vq)
            outcome = self.eval_fn(table)                     # lines 5-28
            limit_tokens = np.unique(np.concatenate(
                [limit_tokens, outcome.problem_token_ids.astype(np.int64)]))
            muQ = int(self.mu * self.Q)
            rho_p = self.rhos[outcome.rho_case]
            eps[:muQ] = eps[:muQ] * (1 + rho_p * tau)         # line 20
            eps = np.clip(eps, 0.0, 1.0)

            history.append(Trial(z.copy(), v.copy(), outcome.cost))
            costs.append(outcome.cost)
            if outcome.cost < best_cost:
                best_cost = outcome.cost
                best_table = table
            run_min.append(best_cost)
            if len(history) >= 3:
                X = np.stack([np.log1p(t.values) for t in history])
                y = np.array([t.cost for t in history])
                self.gp.fit(X, y)
            z, v = self._propose(eps, history, limit_tokens)  # lines 30-31

            # convergence (line 33) on the running best (seed included):
            # bit-identical to the historical min(costs[:i+1]) window on
            # a cold start
            if len(costs) > self.lam:
                window = run_min[-(self.lam + 1):]
                if max(window) - min(window) < self.zeta * max(window[0], 1e-12):
                    converged = True
                    break

        return BOResult(best_table=best_table, best_cost=best_cost,
                        history=history, costs=costs,
                        iterations=len(costs), converged=converged,
                        limit_tokens=limit_tokens.copy(),
                        final_eps=np.asarray(eps, float).copy(),
                        seeded_trials=len(seed_trials))
