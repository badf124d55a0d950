"""Reconfiguration policies: one decision stack for every layer.

The paper's monitor -> predict -> reconfigure loop (§4.1, Fig 7) appears
at three levels of this reproduction — the cycle-level simulator, the
serving engine, and the trainer.  Each policy here answers the same
question at a decision point: *given the telemetry, what topology should
this group take?*  Topologies are integer compositions of the group's
capacity (:mod:`repro.control.space`), so a proposal may be the paper's
heterogeneous cut — ``(5, 3)`` for a skewed tail — not just a ladder
rung.

* :class:`ThresholdPolicy` — the paper's fixed-ratio hysteresis: split
  past ``split_threshold`` when the regroup gain is positive, re-fuse
  under ``fuse_threshold`` (Fig 10/11, lifted verbatim from the old
  ``AmoebaController.observe``).
* :class:`PredictorPolicy` — §4.1.3's logistic scalability model run
  online over a feature vector ("a single MAC per feature").
* :class:`OraclePolicy` — run-both-pick-better: searches the composition
  lattice with a caller-supplied measure (the simulator's dual static
  runs, or the true slot-cost of the live batch) and steps toward the
  argmax one move at a time.
* :class:`OnlinePolicy` — PredictorPolicy plus periodic recency-weighted
  refits from a replay buffer of (features, realized-win) labels, with a
  drift-reset hook; bootstraps from the threshold rule until the first
  fit.

Policies are *advisory*: they propose a topology; the
:class:`~repro.control.controller.GroupController` enforces per-part
dwell and the :class:`~repro.control.space.ConfigSpace` amortization
check before any transition happens.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch.control.features import SERVE_FEATURES, FeatureVector, ReplayBuffer
from repro_torch.control.space import ConfigSpace, Topology, TopologyLike, n_parts
from repro_torch.core import predictor as P
from repro_torch.core.regroup import regroup_gain
from repro_torch.obs.events import NULL_LOG


@dataclass
class Decision:
    """A proposed topology with the evidence behind it.

    ``ways`` is the part count (the legacy scalar every caller already
    understands); ``topology`` carries the exact composition when the
    policy could compute one — the controller materializes a skew-aware
    move itself when it is None.
    """
    ways: int
    proba: float = 0.5            # P(more-split is better), when meaningful
    gain: float = 0.0             # predicted relative slot-waste saving
    reason: str = ""
    topology: Optional[Topology] = None


def _normalize(cur: TopologyLike, space: Optional[ConfigSpace]
               ) -> Tuple[Optional[Topology], int]:
    """(topology or None, part count) from an int-or-tuple current state."""
    if isinstance(cur, int):
        return (space.as_topology(cur) if space is not None else None,
                cur)
    return tuple(cur), len(cur)


# -- the shared hysteresis primitive -----------------------------------------
# Both the scalar serve/train path and the vectorized 24-pair simulator loop
# are instances of this one rule, so it lives here and nowhere else.

def hysteresis_toggle(is_split: np.ndarray, divergence: np.ndarray,
                      split_threshold: float, fuse_threshold: float,
                      want_split: np.ndarray, want_fuse: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(split_now, fuse_now) masks under hysteresis (paper Fig 10/11).

    Split when fused, divergent past the threshold, *and* the caller's
    benefit estimate agrees; fuse when split and either calm below the
    lower threshold or the estimate says fused is better again.
    """
    is_split = np.asarray(is_split, bool)
    split_now = (~is_split) & (np.asarray(divergence) > split_threshold) \
        & np.asarray(want_split, bool)
    fuse_now = is_split & ((np.asarray(divergence) < fuse_threshold)
                           | np.asarray(want_fuse, bool))
    return split_now, fuse_now


class ReconfigPolicy(Protocol):
    """Protocol every policy implements."""
    name: str

    def decide(self, fv: FeatureVector, ways: TopologyLike) -> Decision:
        """Propose a topology given telemetry and the current topology."""
        ...


# ---------------------------------------------------------------------------
# ThresholdPolicy — today's hysteresis + regroup-gain veto
# ---------------------------------------------------------------------------

@dataclass
class ThresholdPolicy:
    """Fixed-ratio hysteresis with a regroup-gain veto on splits."""
    split_threshold: float = 0.25
    fuse_threshold: float = 0.10
    regroup_policy: str = "warp_regroup"
    space: Optional[ConfigSpace] = None
    name: str = "threshold"

    def decide(self, fv: FeatureVector, cur: TopologyLike) -> Decision:
        topo, ways = _normalize(cur, self.space)
        smart = self.space is not None and topo is not None \
            and fv.remaining is not None
        split_now, fuse_now = hysteresis_toggle(
            np.array(ways > 1), np.array(fv.divergence),
            self.split_threshold, self.fuse_threshold,
            want_split=np.array(True), want_fuse=np.array(False))
        if bool(split_now):
            if smart:
                t = self.space.suggest_split(topo, fv.remaining,
                                             self.regroup_policy)
                if t is not None:
                    g = self.space.move_gain(fv.remaining, topo, t,
                                             self.regroup_policy)
                    if g > 0.0:
                        return Decision(
                            len(t), proba=1.0, gain=g, topology=t,
                            reason=f"divergence {fv.divergence:.3f} > "
                                   f"{self.split_threshold}")
                return Decision(ways, reason="hold")
            gain = (regroup_gain(fv.remaining, self.regroup_policy)
                    if fv.remaining is not None else fv.divergence)
            if gain > 0.0:
                return Decision(ways * 2, proba=1.0, gain=gain,
                                reason=f"divergence {fv.divergence:.3f} > "
                                       f"{self.split_threshold}")
        elif ways > 1 and fv.divergence > self.split_threshold and smart:
            # already split but the live mix drifted divergent again:
            # deepen or re-cut the composition (the hysteresis pair
            # above only handles the fused<->split toggle)
            t = self.space.suggest_improve(topo, fv.remaining,
                                           self.regroup_policy)
            if t is not None:
                g = self.space.move_gain(fv.remaining, topo, t,
                                         self.regroup_policy)
                if g > 0.0:
                    return Decision(
                        len(t), proba=1.0, gain=g, topology=t,
                        reason=f"recut: divergence {fv.divergence:.3f} > "
                               f"{self.split_threshold}")
            return Decision(ways, reason="hold")
        elif bool(fuse_now):
            t = None
            if self.space is not None and topo is not None:
                t = self.space.suggest_fuse(topo, fv.remaining,
                                            self.regroup_policy)
            return Decision(len(t) if t is not None else ways // 2,
                            proba=0.0, gain=0.0, topology=t,
                            reason=f"divergence {fv.divergence:.3f} < "
                                   f"{self.fuse_threshold}")
        return Decision(ways, reason="hold")


# ---------------------------------------------------------------------------
# PredictorPolicy — logistic inference over live telemetry
# ---------------------------------------------------------------------------

@dataclass
class PredictorPolicy:
    """§4.1.3's binary logistic model in the loop.

    ``positive_means_split`` fixes the label convention: serve-level
    corpora label 1 = "splitting wins", while the gpusim corpus labels
    1 = "fused/scale-up wins" (the paper's convention).  ``proba_band``
    is the hysteresis band around 0.5 that rate-limits topology flapping.
    """
    model: Optional[P.LogisticModel] = None
    proba_band: float = 0.10
    regroup_policy: str = "warp_regroup"
    positive_means_split: bool = True
    space: Optional[ConfigSpace] = None
    name: str = "predictor"

    @classmethod
    def from_decider(cls, fuse_decider: Callable[[np.ndarray], bool]
                     ) -> "PredictorPolicy":
        """Wrap a bare features->fuse? callable (the gpusim interface)."""
        pol = cls(model=None, positive_means_split=False)
        pol._decider = fuse_decider
        return pol

    def proba_split(self, x: np.ndarray) -> float:
        """P(the more-split configuration wins) under the model."""
        decider = getattr(self, "_decider", None)
        if decider is not None:
            return 0.0 if bool(decider(np.asarray(x))) else 1.0
        if self.model is None:
            raise ValueError("PredictorPolicy needs a model or a decider")
        p = float(P.predict_proba(self.model, np.asarray(x, np.float64)))
        return p if self.positive_means_split else 1.0 - p

    def feature_impacts(self, x: np.ndarray) -> Dict[str, float]:
        """Paper Fig 20 at the serve level: per-feature impact of one
        decision point (standardized value x coefficient).  Positive
        entries push toward splitting under the serve label convention.
        """
        if self.model is None:
            raise ValueError("feature_impacts needs a trained model")
        imp = np.asarray(P.feature_impacts(self.model,
                                           np.asarray(x, np.float64)))
        if not self.positive_means_split:
            imp = -imp
        names = self.model.feature_names or SERVE_FEATURES
        return {name: float(v) for name, v in zip(names, imp)}

    def choose_static(self, features: np.ndarray) -> bool:
        """One-shot per-kernel choice: True = fuse (the gpusim path).

        Fusing needs a strict majority — a 0.5 tie stays scale-out, the
        paper's default configuration.
        """
        return self.proba_split(features) < 0.5

    def decide(self, fv: FeatureVector, cur: TopologyLike) -> Decision:
        topo, ways = _normalize(cur, self.space)
        p = self.proba_split(fv.to_array())
        if p > 0.5 + self.proba_band / 2:
            # gain is the *true* predicted slot-waste saving so the
            # ConfigSpace amortization floor still gates a confident but
            # wrong model; model confidence only stands in when no live
            # remaining lengths exist to score (computed in this branch
            # only — hold/fuse ticks never consume it)
            t = None
            if fv.remaining is None:
                gain = p - 0.5
            elif topo is not None and self.space is not None:
                # deepen from fused; deepen-or-recut once already split
                t = self.space.suggest_improve(topo, fv.remaining,
                                               self.regroup_policy)
                gain = 0.0 if t is None else self.space.move_gain(
                    fv.remaining, topo, t, self.regroup_policy)
            else:
                gain = regroup_gain(fv.remaining, self.regroup_policy)
            return Decision(len(t) if t is not None else ways * 2,
                            proba=p, gain=gain, topology=t,
                            reason=f"P(split)={p:.3f}")
        if p < 0.5 - self.proba_band / 2 and ways > 1:
            t = None if self.space is None or topo is None \
                else self.space.suggest_fuse(topo, fv.remaining,
                                             self.regroup_policy)
            return Decision(len(t) if t is not None else ways // 2,
                            proba=p, topology=t, reason=f"P(split)={p:.3f}")
        return Decision(ways, proba=p, reason="inside hysteresis band")


# ---------------------------------------------------------------------------
# OraclePolicy — run-both-pick-better over the composition lattice
# ---------------------------------------------------------------------------

@dataclass
class OraclePolicy:
    """Search the composition lattice; step toward the argmax.

    ``score(topology, fv) -> utility`` is caller-supplied: the simulator
    measures both static configurations' IPC (the label-generation path
    that used to live inside ``gpusim.sim.run_benchmark``); the serving
    engine defaults to the true relative slot-waste saving of the live
    batch.  With the default score the target comes from
    :meth:`ConfigSpace.best_topology` (the global lattice argmax); with
    a custom score only the current topology's one-move frontier is
    scored each tick — either way the oracle emits exactly one legal
    move per decision.  ``margin`` is the improvement a split must show
    over the current topology's score — the oracle's hysteresis; fusing
    back is preferred on ties (it restores the wide configuration's
    coalescing for free).
    """
    space: ConfigSpace = field(default_factory=lambda: ConfigSpace(2))
    score: Optional[Callable[[TopologyLike, Optional[FeatureVector]],
                             float]] = None
    margin: float = 0.02
    regroup_policy: str = "warp_regroup"
    name: str = "oracle"

    def _score(self, t: TopologyLike, fv: Optional[FeatureVector]) -> float:
        if self.score is not None:
            return float(self.score(t, fv))
        if fv is None or fv.remaining is None:
            return 0.0
        return self.space.gain(fv.remaining, t, self.regroup_policy)

    def choose_static(self, features=None) -> bool:
        """One-shot choice: True = fused (ways=1) scores strictly higher."""
        return self._score(1, None) > self._score(2, None)

    def _target(self, cur: Topology, fv: FeatureVector
                ) -> Tuple[Topology, float, float]:
        """(target, best_score, cur_score) under the active measure.

        The target is the *least-split* topology scoring within
        ``margin`` of the lattice best — the fuse-back hysteresis: a
        split whose edge over wider configurations has shrunk below the
        margin is not worth its lost coalescing, so the target drops
        back toward fused.
        """
        cur_score = self._score(cur, fv)
        if self.score is None and fv.remaining is not None:
            try:
                comps = self.space.compositions()
            except ValueError:              # lattice too large to scan
                comps = None
            if comps is not None:
                # one pass: compositions are ordered fused-first by part
                # count, so the first within-margin hit is least-split
                gains = [(t, self.space.gain(fv.remaining, t,
                                             self.regroup_policy))
                         for t in comps]
                top = max(g for _, g in gains)
                for t, g in gains:
                    if g >= top - self.margin:
                        return t, top, cur_score
            best, top = self.space.best_topology(
                fv.remaining, self.regroup_policy)
            if 0.0 >= top - self.margin:    # fused is within margin
                return (self.space.capacity,), top, cur_score
            return best, top, cur_score
        best, best_score = cur, cur_score
        for nb in self.space.neighbors(cur):
            s = self._score(nb, fv)
            if s > best_score + 1e-12 or (
                    s > best_score - 1e-12 and len(nb) < len(best)):
                best, best_score = nb, s
        if self._score((self.space.capacity,), fv) >= best_score - self.margin:
            best = (self.space.capacity,)
        return best, best_score, cur_score

    def decide(self, fv: FeatureVector, cur: TopologyLike) -> Decision:
        cur_t, ways = _normalize(cur, self.space)
        if cur_t is None:
            cur_t = self.space.as_topology(ways)
        target, top, cur_score = self._target(cur_t, fv)
        if target != cur_t and len(target) >= len(cur_t) \
                and top > cur_score + self.margin:
            # deeper or re-cut: take the best single improving move
            step = self.space.suggest_improve(cur_t, fv.remaining,
                                              self.regroup_policy)
            if step is None:
                step = self.space.suggest_split(cur_t, fv.remaining,
                                                self.regroup_policy)
        elif len(target) < len(cur_t):
            step = self.space.suggest_fuse(cur_t, fv.remaining,
                                           self.regroup_policy)
        else:
            return Decision(ways, gain=cur_score, reason="oracle: hold")
        if step is None:
            return Decision(ways, gain=cur_score, reason="oracle: hold")
        gain = self.space.move_gain(fv.remaining, cur_t, step,
                                    self.regroup_policy) \
            if fv.remaining is not None else abs(top - cur_score)
        return Decision(len(step), topology=step,
                        proba=1.0 if len(step) > len(cur_t) else 0.0,
                        gain=gain,
                        reason=f"oracle: {self.space.name(target)} scores "
                               f"{top:.3f} vs {cur_score:.3f}")


# ---------------------------------------------------------------------------
# OnlinePolicy — predictor + periodic refit from the replay buffer
# ---------------------------------------------------------------------------

@dataclass
class OnlinePolicy:
    """Logistic inference that retrains itself from realized outcomes.

    Bootstraps from :class:`ThresholdPolicy` until the replay buffer has
    ``min_samples`` with both labels present, then fits (and every
    ``refit_every`` decisions refits) a logistic model via
    ``predictor.train_logistic`` — whose per-epoch loss history is kept
    in ``refit_info`` so convergence is observable.

    Refits are *recency-weighted*: each replay sample's weight decays
    exponentially with its age (``half_life`` newer samples count double
    vs samples one half-life older), so a regime change stops dominating
    the fit long before the FIFO evicts it.  A drift check runs before
    every refit: when the fitted model's accuracy over the newest
    ``drift_window`` labels falls below ``drift_threshold`` the buffer
    resets to that window and the policy drops back to the threshold
    bootstrap until enough fresh samples accumulate (the explicit
    forget-now path for bursty -> steady regime changes).
    """
    replay: ReplayBuffer = field(default_factory=ReplayBuffer)
    bootstrap: ThresholdPolicy = field(default_factory=ThresholdPolicy)
    proba_band: float = 0.10
    refit_every: int = 64
    min_samples: int = 48
    train_steps: int = 300
    space: Optional[ConfigSpace] = None
    half_life: Optional[int] = 512
    drift_window: int = 32
    drift_threshold: float = 0.35
    name: str = "online"

    def __post_init__(self):
        self._inner = PredictorPolicy(
            model=None, proba_band=self.proba_band,
            regroup_policy=self.bootstrap.regroup_policy,
            positive_means_split=True, space=self.space)
        self._decisions = 0
        self.refits = 0
        self.drift_resets = 0
        self.refit_info: List[Dict] = []
        # event stream (repro.obs); the engine that owns the run wires
        # its log in, so refits/drift-resets land in the same trace as
        # the decisions they retrain on
        self.obs = NULL_LOG

    @property
    def fitted(self) -> bool:
        return self._inner.model is not None

    def drift_detected(self) -> bool:
        """True when the model disagrees with the newest realized labels."""
        if not self.fitted or len(self.replay) < self.drift_window:
            return False
        X, y = self.replay.tail(self.drift_window)
        if len(set(y.tolist())) < 2:
            return False                    # one-class window: no signal
        # one batched predict over the whole window (the inner policy is
        # always positive_means_split, so proba IS P(split wins))
        proba = np.asarray(P.predict_proba(self._inner.model,
                                           np.asarray(X, np.float64)))
        return float(np.mean((proba > 0.5) == (y > 0.5))) \
            < self.drift_threshold

    def reset_on_drift(self) -> bool:
        """The drift-reset hook: forget the stale regime immediately.

        Keeps only the newest ``drift_window`` samples, drops the fitted
        model (back to the threshold bootstrap), and lets the normal
        refit cadence pick the fresh regime up.  Also callable by an
        outer controller that detects drift out-of-band.
        """
        self.replay.reset(keep_last=self.drift_window)
        self._inner.model = None
        self.drift_resets += 1
        return True

    def maybe_refit(self) -> bool:
        if self.drift_detected():
            self.reset_on_drift()
            if self.obs.enabled:
                self.obs.emit("refit", event="drift_reset",
                              drift_resets=self.drift_resets,
                              kept=min(len(self.replay), self.drift_window))
            return False
        buf = self.replay
        if len(buf) < self.min_samples:
            return False
        balance = buf.label_balance()
        if balance <= 0.02 or balance >= 0.98:
            return False                    # one-class buffer: nothing to fit
        X, y, w = buf.weighted_dataset(self.half_life)
        model, info = P.train_logistic(
            X, y, feature_names=SERVE_FEATURES, steps=self.train_steps,
            sample_weight=w)
        self._inner.model = model
        self.refits += 1
        self.refit_info.append({
            "n": info["n"], "train_accuracy": info["train_accuracy"],
            "final_nll": info["final_nll"],
            "loss_history_tail": [round(float(v), 5)
                                  for v in info["loss_history"][-5:]],
            "drift_resets": self.drift_resets,
        })
        if self.obs.enabled:
            self.obs.emit("refit", event="refit", refits=self.refits,
                          n=int(info["n"]),
                          train_accuracy=float(info["train_accuracy"]))
        return True

    def decide(self, fv: FeatureVector, cur: TopologyLike) -> Decision:
        self._decisions += 1
        if (not self.fitted and len(self.replay) >= self.min_samples) \
                or (self.refit_every and
                    self._decisions % self.refit_every == 0):
            self.maybe_refit()
        if self.fitted:
            d = self._inner.decide(fv, cur)
            d.reason = f"online[{self.refits} fits] {d.reason}"
            return d
        d = self.bootstrap.decide(fv, cur)
        d.reason = f"online[bootstrap] {d.reason}"
        return d


POLICY_NAMES = ("threshold", "predictor", "oracle", "online")


def make_policy(name: str, *, space: ConfigSpace,
                split_threshold: float = 0.25, fuse_threshold: float = 0.10,
                regroup_policy: str = "warp_regroup",
                model: Optional[P.LogisticModel] = None,
                model_path: Optional[str] = None,
                replay: Optional[ReplayBuffer] = None,
                proba_band: float = 0.10, oracle_margin: float = 0.02,
                refit_every: int = 64) -> ReconfigPolicy:
    """Factory mapping ``AmoebaConfig.policy`` names onto policy objects."""
    if name == "threshold":
        return ThresholdPolicy(split_threshold, fuse_threshold,
                               regroup_policy, space=space)
    if name == "predictor":
        if model is None and model_path:
            model = P.load_model(model_path)
        if model is None:
            raise ValueError("policy='predictor' needs a trained model "
                             "(AmoebaConfig.predictor_path or model=...)")
        return PredictorPolicy(model=model, proba_band=proba_band,
                               regroup_policy=regroup_policy, space=space)
    if name == "oracle":
        return OraclePolicy(space=space, margin=oracle_margin,
                            regroup_policy=regroup_policy)
    if name == "online":
        return OnlinePolicy(
            replay=replay if replay is not None else ReplayBuffer(),
            bootstrap=ThresholdPolicy(split_threshold, fuse_threshold,
                                      regroup_policy, space=space),
            proba_band=proba_band, refit_every=refit_every, space=space)
    raise ValueError(f"unknown policy {name!r}; have {POLICY_NAMES}")
