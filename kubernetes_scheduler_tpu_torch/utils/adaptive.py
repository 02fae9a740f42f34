"""Adaptive scalar-vs-device dispatch model.

The right `min_device_work` threshold is deployment-dependent: the device
path's fixed cost depends on where the engine runs (a remote sidecar's
round-trip against an in-process engine), while the C++ scalar path costs
a few nanoseconds per pod x node cell — so any STATIC pods*nodes threshold
is wrong somewhere. Instead the scheduler
can learn both paths' latency models online and route each cycle to the
predicted-faster path.

Model: per path, t(cells) = overhead + rate * cells, fitted by recursive
least squares on (cells, seconds) observations from real cycles. The
scalar path's overhead is ~0 and the device path's is its dispatch
round-trip, so two parameters per path capture exactly the regime split
the static threshold approximates. Until a path has enough observations
the caller falls back to the static threshold, and a periodic exploration
cycle keeps the underdog path's estimate fresh.
"""

from __future__ import annotations

CELL_SCALE = 1.0e6  # cells normalized to millions: keeps the fit well-conditioned

# Tikhonov floor for the normal-equation solve. Under CONSTANT cycle
# shape — steady-state full windows on a fixed cluster, the common case —
# the decayed Gram matrix is rank-1 and the affine fit is unidentifiable;
# the ridge pins the unexcited direction to the zero prior while the
# excited direction (the only one predictions at observed shapes use)
# fits the data exactly. It also bounds the condition number, which is
# what classic forgetting-RLS lacks: there the covariance grows 1/forget
# per step along unexcited directions and overflows to inf after ~35k
# constant-shape observations, turning the fit to NaN and wedging
# dispatch permanently (found by review; pinned in test_adaptive).
RIDGE = 1e-9


class PathModel:
    """Exponentially-weighted least-squares fit of
    t = overhead + rate * (cells / CELL_SCALE).

    Kept as decayed normal-equation sums (Gram matrix + moment vector),
    solved with a ridge floor at prediction time. Same effective
    ~1/(1-forget)-observation window as forgetting-RLS, but every state
    component is a decayed sum of bounded inputs, so the estimator is
    bounded by construction — no covariance windup, no divergence, full
    adaptivity after arbitrarily long constant-excitation stretches.
    """

    def __init__(self, forget: float = 0.98):
        self.forget = forget
        # decayed sums: Gram [[1,x],[x,x2]] and moments [y, xy]
        self.s11 = 0.0
        self.s1x = 0.0
        self.sxx = 0.0
        self.sy = 0.0
        self.sxy = 0.0
        self.n_obs = 0

    def observe(self, cells: int, seconds: float) -> None:
        if cells <= 0 or seconds <= 0:
            return
        x = cells / CELL_SCALE
        lam = self.forget
        self.s11 = lam * self.s11 + 1.0
        self.s1x = lam * self.s1x + x
        self.sxx = lam * self.sxx + x * x
        self.sy = lam * self.sy + seconds
        self.sxy = lam * self.sxy + x * seconds
        self.n_obs += 1

    def _theta(self) -> tuple[float, float]:
        a, b, c = self.s11 + RIDGE, self.s1x, self.sxx + RIDGE
        det = a * c - b * b
        if det <= 0.0:
            return 0.0, 0.0
        t0 = (c * self.sy - b * self.sxy) / det
        t1 = (a * self.sxy - b * self.sy) / det
        return t0, t1

    def predict(self, cells: int) -> float:
        t0, t1 = self._theta()
        t = t0 + t1 * (cells / CELL_SCALE)
        # an extrapolating or partially-fitted model can dip negative;
        # clamp to "free"
        return max(t, 0.0)


class AdaptiveDispatch:
    """Route a cycle to the path with the lower predicted latency.

    decide(cells) -> True for the device path. Falls back to the static
    pods*nodes threshold until BOTH paths have >= min_obs observations;
    every `explore_every`-th decision routes to the other path so a
    path that lost early never starves of fresh observations (latency
    regimes shift: sidecar restarts, thermal throttling, host load).
    """

    def __init__(
        self,
        static_threshold: int,
        *,
        min_obs: int = 3,
        explore_every: int = 32,
        explore_ratio_cap: float = 10.0,
    ):
        self.static_threshold = static_threshold
        self.scalar = PathModel()
        self.device = PathModel()
        self.min_obs = min_obs
        self.explore_every = explore_every
        # exploration is bounded: flip to the underdog only when its
        # predicted time is within this factor of the winner's — a path
        # predicted 100x slower (e.g. a Python scalar rescore of a
        # 10M-cell window) is a latency spike, not an experiment
        self.explore_ratio_cap = explore_ratio_cap
        self._decisions = 0
        self._device_warmups = 0
        self._device_outliers = 0

    def observe(self, used_device: bool, cells: int, seconds: float) -> None:
        if used_device and self._device_warmups < 1:
            # the first device cycle pays the one-time warm-up (kernel
            # build, allocator growth); fitting it would poison the
            # overhead estimate for hundreds of cycles under forget=0.98
            self._device_warmups += 1
            return
        if used_device and self.device.n_obs >= self.min_obs:
            # later bucket changes (window/node shapes) pay warm-up
            # again: a sample far above the fitted prediction is
            # a warm-up spike, not steady-state latency — but THREE in a
            # row is a real regime shift and must be believed, or a
            # genuinely degraded device path would never be re-modeled
            pred = self.device.predict(cells)
            if seconds > 10.0 * max(pred, 1e-4):
                self._device_outliers += 1
                if self._device_outliers < 3:
                    return
            else:
                self._device_outliers = 0
        (self.device if used_device else self.scalar).observe(cells, seconds)

    def decide(self, cells: int) -> bool:
        self._decisions += 1
        fitted = (
            self.scalar.n_obs >= self.min_obs
            and self.device.n_obs >= self.min_obs
        )
        if not fitted:
            # cold start: static threshold, but force early samples of the
            # un-observed path so the model can take over. Forced SCALAR
            # samples are bounded to near-threshold sizes — a scalar pass
            # over a 25M-cell window is a multi-second spike, the exact
            # thing explore_ratio_cap forbids post-fit (the device side
            # needs no such bound: its cost is overhead-dominated)
            if self.scalar.n_obs < self.min_obs <= self.device.n_obs:
                return not (cells <= 4 * max(self.static_threshold, 1))
            if self.device.n_obs < self.min_obs <= self.scalar.n_obs:
                return True
            return cells >= self.static_threshold
        t_dev = self.device.predict(cells)
        t_sca = self.scalar.predict(cells)
        choice = t_dev <= t_sca
        if self._decisions % self.explore_every == 0:
            worse, better = max(t_dev, t_sca), min(t_dev, t_sca)
            if worse <= self.explore_ratio_cap * max(better, 1e-6):
                return not choice
        return choice
