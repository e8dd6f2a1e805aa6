"""Adaptive Byzantine attacks: stateful adversaries on the public round feed.

Counterpart of ``byzpy_tpu/attacks/adaptive.py``. A realistic adversary
participates in the protocol: it pulls the broadcast model like every
client, sees which of its submissions were accepted, and optimizes the
next one through :meth:`~byzpy_tpu_torch.attacks.base.Attack.observe_round`:

* :class:`PublicRoundState` — what a client legitimately learns per
  round: the broadcast aggregate, the server round counter, per-client
  acceptance decisions and the admission layer's ack verdicts;
* :class:`AdaptiveAttack` — stateful base with deterministic per-instance
  randomness;
* :class:`InfluenceAscentAttack` — a multiplicative line search on the
  attack magnitude along a malicious direction;
* :class:`KrumEvasionAttack` — mimicry of the published consensus plus a
  bias that shrinks whenever it loses selection;
* :class:`StalenessAbuseAttack` — submissions stamped at the oldest
  admissible round and pre-inflated to cancel the staleness discount;
* :class:`ResidualShapingAttack` — error-feedback residual shaping on a
  ``kappa``-inflated wire grid.

The state machine is the JAX package's, unchanged: float32 numpy
arithmetic and a per-instance ``np.random.default_rng(seed)``, so the same
observation sequence gives the same submission bits in both packages.
Only the boundary differs: an observed aggregate may be a tensor on any
device (it is read to the host as f32), and a submission leaves as a
float32 tensor on the attack's ``device``. None of these attacks requests
``honest_grads``: they use public information only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike
from .base import Attack


@dataclass(frozen=True)
class PublicRoundState:
    """One closed round's public outcome, as an adaptive adversary sees it.

    ``aggregate`` is the broadcast update/model delta every client pulls
    (a ``(d,)`` array or tensor, on any device); ``accepted`` maps client
    ids to the round's acceptance/selection verdict where the fabric
    publishes one (empty when it doesn't); ``verdicts`` maps client ids to
    admission-layer ack reason strings (``accepted``/``rejected_rate``/
    ``rejected_too_stale``/… — each client at least knows its own acks);
    ``server_round`` is the server's round counter at broadcast time
    (what a submission's staleness δ is measured against)."""

    round_id: int
    aggregate: Any
    accepted: Mapping[str, bool] = field(default_factory=dict)
    verdicts: Mapping[str, str] = field(default_factory=dict)
    server_round: int = 0


class AdaptiveAttack(Attack):
    """Stateful attack base over the :meth:`observe_round` feed.

    Subclasses implement ``_update(state)`` (digest one observation) and
    ``apply`` (emit the next submission from current state). Determinism
    contract: all state transitions are pure functions of the
    constructor arguments and the observation sequence — float32 numpy
    arithmetic, per-instance ``np.random.Generator`` seeded from
    ``seed`` — so identical observations replay identical submissions
    (pinned against the JAX package by ``tests/test_torch_attacks.py``).
    Submissions leave as float32 tensors on ``device``."""

    is_adaptive = True
    name = "adaptive"

    def __init__(self, dim: int, *, seed: int = 0, client_id: str = "byz",
                 device: DeviceLike = None) -> None:
        if dim <= 0:
            raise ValueError(f"dim must be >= 1 (got {dim})")
        super().__init__(device=device)
        self.dim = int(dim)
        self.client_id = str(client_id)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.observations: List[PublicRoundState] = []
        self.submissions = 0

    # -- observation channel ------------------------------------------------

    def observe_round(self, public_state: PublicRoundState) -> None:
        """Digest one round's public outcome (appends to ``observations``
        then delegates to the subclass's ``_update``)."""
        self.observations.append(public_state)
        self._update(public_state)

    def _update(self, state: PublicRoundState) -> None:
        """Subclass hook: fold one observation into attack state."""

    # -- convenience --------------------------------------------------------

    def _aggregate_estimate(self) -> np.ndarray:
        """The attacker's best public estimate of the honest consensus:
        the last broadcast aggregate (zeros before any observation)."""
        if not self.observations:
            return np.zeros((self.dim,), np.float32)
        return _host_f32(self.observations[-1].aggregate)[: self.dim]

    def _emit(self, vec: np.ndarray) -> torch.Tensor:
        """A host float32 submission as a tensor on the attack's device."""
        return torch.from_numpy(np.ascontiguousarray(vec, np.float32)).to(self.device)

    def _was_accepted(self, state: PublicRoundState) -> Optional[bool]:
        """This attacker's acceptance verdict in ``state`` (None when the
        round published no per-client decision for it)."""
        if self.client_id in state.accepted:
            return bool(state.accepted[self.client_id])
        return None


def _host_f32(value: Any) -> np.ndarray:
    """``value`` (a tensor on any device, or anything numpy reads) as a
    flat float32 numpy array on the host."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32).reshape(-1)


def _unit(direction: Any, dim: int) -> np.ndarray:
    """Normalized float32 direction vector (default: all-ones)."""
    if direction is None:
        vec = np.ones((dim,), np.float32)
    else:
        vec = _host_f32(direction)
        if vec.shape[0] != dim:
            raise ValueError(f"direction has {vec.shape[0]} coords, expected {dim}")
    norm = float(np.linalg.norm(vec))
    if norm == 0.0:
        raise ValueError("direction must be non-zero")
    return (vec / np.float32(norm)).astype(np.float32)


class InfluenceAscentAttack(AdaptiveAttack):
    """Gradient-ascent on aggregator influence.

    Goal: drag the broadcast aggregate along ``direction``. Each round
    the attacker measures its *realized influence* — the component of
    the broadcast aggregate along the malicious direction — and runs a
    multiplicative line search on its attack magnitude ``scale``:

    * influence improved (the aggregator passed the push through) →
      ``scale *= grow``: push harder next round;
    * influence regressed (trimmed/clipped/excluded — the push
      backfired or vanished) → ``scale *= shrink``: retreat back inside
      the aggregator's tolerance.

    The submission is ``estimate + scale · direction`` where
    ``estimate`` is the last broadcast aggregate — so the row sits near
    the honest consensus and the whole budget goes into the directional
    push. Against a trimmed mean this converges from either side onto
    the largest per-coordinate offset that still survives the trim
    window (the 'a little is enough' magnitude, *learned online* instead
    of assumed from known honest variance); a static attack at a fixed
    large scale is trimmed to zero influence every round
    (``benchmarks/chaos_bench.py`` 'adaptive' lane measures the gap)."""

    name = "influence-ascent"

    def __init__(
        self,
        dim: int,
        *,
        direction: Any = None,
        scale0: float = 0.05,
        grow: float = 1.6,
        shrink: float = 0.5,
        max_scale: float = 1e3,
        seed: int = 0,
        client_id: str = "byz",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(dim, seed=seed, client_id=client_id, device=device)
        if not (0.0 < shrink < 1.0 < grow):
            raise ValueError("need 0 < shrink < 1 < grow")
        self.direction = _unit(direction, dim)
        self.scale = np.float32(scale0)
        self.grow = np.float32(grow)
        self.shrink = np.float32(shrink)
        self.max_scale = np.float32(max_scale)
        self._last_influence: Optional[np.float32] = None

    def _update(self, state: PublicRoundState) -> None:
        influence = np.float32(
            np.dot(
                _host_f32(state.aggregate)[: self.dim],
                self.direction,
            )
        )
        if self._last_influence is None or influence > self._last_influence:
            self.scale = min(self.scale * self.grow, self.max_scale)
        else:
            self.scale = self.scale * self.shrink
        self._last_influence = influence

    def apply(self, *, model=None, x=None, y=None,
              honest_grads=None, base_grad=None) -> torch.Tensor:
        """Next submission: consensus estimate + current push."""
        self.submissions += 1
        return self._emit(
            (self._aggregate_estimate() + self.scale * self.direction).astype(np.float32)
        )


class KrumEvasionAttack(AdaptiveAttack):
    """Krum evasion via mimicry of accepted rows.

    Selection aggregators (Krum, Multi-Krum, CGE, MoNNA) publish — via
    the broadcast itself — a consensus of the *accepted* rows. The
    evader submits exactly that public consensus plus an adaptive bias
    ``eps · direction``:

    * while it keeps being selected (its id in the published accepted
      set, or no exclusion signal) → ``eps *= grow``: steer harder;
    * the round it loses selection → ``eps *= shrink``: snap back to
      near-perfect mimicry and re-enter the accepted set.

    A static outlier is excluded by Krum in round 0 and never scores
    again; the mimic stays inside the selection for many rounds
    (``exclusion_round`` metric in the chaos grid) while biasing every
    round's output it participates in."""

    name = "krum-evasion"

    def __init__(
        self,
        dim: int,
        *,
        direction: Any = None,
        eps0: float = 0.01,
        grow: float = 1.5,
        shrink: float = 0.25,
        max_eps: float = 1e3,
        seed: int = 0,
        client_id: str = "byz",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(dim, seed=seed, client_id=client_id, device=device)
        if not (0.0 < shrink < 1.0 < grow):
            raise ValueError("need 0 < shrink < 1 < grow")
        self.direction = _unit(direction, dim)
        self.eps = np.float32(eps0)
        self.grow = np.float32(grow)
        self.shrink = np.float32(shrink)
        self.max_eps = np.float32(max_eps)

    def _update(self, state: PublicRoundState) -> None:
        # exclusion = an explicit accepted=False, OR an admission-layer
        # rejection ack (a serving feed encodes cohort membership only
        # as presence, so the attacker's own non-accepted ack is the
        # other public signal that its row did not score)
        accepted = self._was_accepted(state)
        verdict = state.verdicts.get(self.client_id)
        rejected = verdict is not None and verdict != "accepted"
        if accepted is False or rejected:
            self.eps = self.eps * self.shrink
        else:
            self.eps = min(self.eps * self.grow, self.max_eps)

    def apply(self, *, model=None, x=None, y=None,
              honest_grads=None, base_grad=None) -> torch.Tensor:
        """Next submission: mimic the published consensus, plus bias."""
        self.submissions += 1
        return self._emit(
            (self._aggregate_estimate() + self.eps * self.direction).astype(np.float32)
        )


class StalenessAbuseAttack(AdaptiveAttack):
    """Staleness-window abuse against the serving tier.

    The serving frontend admits a round-``k`` submission up to
    ``cutoff`` rounds late and folds it discounted by ``discount(δ)``
    (:class:`~byzpy_tpu_torch.serving.staleness.StalenessPolicy`) — both
    policy parameters are public (clients must know them to participate).
    The abuser therefore:

    * stamps every submission at the OLDEST admissible round
      (``δ = cutoff``), maximizing the window between computing its
      payload and the geometry the aggregator judges it against;
    * pre-inflates the payload by ``1 / discount(δ)`` so the tier's
      discount cancels exactly — the row enters the cohort at full
      intended magnitude even though it was "discounted";
    * paces itself under the published credit policy (one submission per
      admission opportunity — the token bucket never rejects it, so it
      never burns reputation with ``rejected_rate`` acks), retreating
      for ``backoff_rounds`` after any rejection verdict.

    ``next_round_stamp(server_round)`` is the round id to put on the
    wire; ``apply`` returns the pre-inflated gradient row. Outcome
    against each aggregator (contained or breached) is measured by the
    ``serving`` lane of ``benchmarks/chaos_bench.py`` and reported in
    ``benchmarks/RESULTS.md``; the defensive moral — magnitude screens
    must run post-discount — is documented in ``docs/serving.md``."""

    name = "staleness-abuse"

    def __init__(
        self,
        dim: int,
        *,
        staleness: Any = None,
        direction: Any = None,
        scale: float = 1.0,
        backoff_rounds: int = 1,
        seed: int = 0,
        client_id: str = "byz",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(dim, seed=seed, client_id=client_id, device=device)
        from ..serving.staleness import StalenessPolicy

        self.staleness = (
            staleness if staleness is not None else StalenessPolicy()
        )
        if not isinstance(self.staleness, StalenessPolicy):
            raise TypeError("staleness must be a StalenessPolicy")
        self.direction = _unit(direction, dim)
        self.scale = np.float32(scale)
        self.backoff_rounds = int(backoff_rounds)
        self._cooldown = 0

    @property
    def delta(self) -> int:
        """The staleness the attack CLAIMS right now: the policy's
        cutoff, clamped to the last observed server round (a round-2
        server cannot be handed a round −2 gradient; before the cutoff
        is reachable the attack claims what it can). 0 when the policy
        has no cutoff — nothing to abuse, submissions go out fresh."""
        cutoff = int(self.staleness.cutoff or 0)
        server = (
            int(self.observations[-1].server_round)
            if self.observations
            else 0
        )
        return min(cutoff, server)

    @property
    def inflation(self) -> np.float32:
        """``1 / discount(δ)`` for the CLAIMED δ — the pre-inflation
        that cancels the tier's staleness discount bit-for-bit at fold
        time (grows with the server round until the cutoff caps it)."""
        return np.float32(1.0 / self.staleness.discount(self.delta))

    def next_round_stamp(self, server_round: int) -> int:
        """The round id to stamp on the next submission: the oldest the
        cutoff admits (clamped at round 0)."""
        return max(0, int(server_round) - int(self.staleness.cutoff or 0))

    def should_submit(self) -> bool:
        """Credit pacing: False while backing off after a rejection."""
        return self._cooldown <= 0

    def _update(self, state: PublicRoundState) -> None:
        verdict = state.verdicts.get(self.client_id)
        if verdict is not None and verdict != "accepted":
            self._cooldown = self.backoff_rounds
        elif self._cooldown > 0:
            self._cooldown -= 1

    def apply(self, *, model=None, x=None, y=None,
              honest_grads=None, base_grad=None) -> torch.Tensor:
        """Next submission: the consensus estimate plus the malicious
        push, pre-inflated to cancel the staleness discount."""
        self.submissions += 1
        payload = self._aggregate_estimate() + self.scale * self.direction
        return self._emit((self.inflation * payload).astype(np.float32))


#: The integer-grid wire modes an encoder-controlling client can shape
#: (fp8 shaping is the same scale-inflation signature on the format
#: grid; the code maxima themselves come from the wire codec's own
#: table at call time so the two can never drift).
_SHAPE_MODES = ("int8", "s4")


def _shaped_wire_roundtrip(
    payload: np.ndarray, mode: str, block: int, kappa: float
) -> tuple:
    """What a residual-shaping client's self-controlled encoder emits:
    blockwise codes on a ``kappa``-inflated scale grid (each block's
    scale is ``kappa * absmax / qmax`` instead of the honest
    ``absmax / qmax``), plus the resulting decode and the PRE-decode
    inflation ratio an ingress would measure. The grid constant comes
    from ``engine.actor.wire._WIRE_QMAX`` and the ratio is computed by
    the REAL ``wire.frame_inflation`` over the shaped frame's actual
    code layout — the attack and the countermeasure read one rulebook.
    Returns ``(decoded, inflation)``."""
    from ..engine.actor import wire as _wire

    qmax = _wire._WIRE_QMAX[mode]
    flat = np.ascontiguousarray(payload, np.float32).ravel()
    n = flat.size
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    xb = flat.reshape(nb, block)
    absmax = np.max(np.abs(xb), axis=1)
    scales = np.where(
        absmax > 0, absmax / qmax * np.float32(kappa), 1.0
    ).astype(np.float32)
    codes = np.clip(np.rint(xb / scales[:, None]), -qmax, qmax)
    decoded = (codes * scales[:, None]).ravel()[:n].astype(np.float32)
    if mode == "s4":
        nib = (codes + 8.0).astype(np.uint8).ravel()
        wire_codes = nib[0::2] | (nib[1::2] << 4)  # packed, block-padded
    else:
        wire_codes = codes.astype(np.int8).ravel()[:n]
    inflation = _wire.frame_inflation(
        _wire.QuantizedWireArray(
            mode, torch.from_numpy(wire_codes), torch.from_numpy(scales), block,
            tuple(payload.shape), "float32"
        )
    )
    return decoded.reshape(payload.shape), float(inflation)


class ResidualShapingAttack(InfluenceAscentAttack):
    """Error-feedback residual shaping on the sub-int8 wire fabric.

    Error feedback makes the compressed uplink *stateful*: an honest
    client carries the residual its encoder lost and folds it into the
    next frame. A Byzantine client CONTROLS its encoder, so it can
    shape both halves of that loop:

    * it inflates its per-block scales by ``kappa`` (> 1) — a grid
      ``kappa``x coarser than its content needs. Post-decode the row
      still lands near the honest consensus (the coarse rounding is
      absorbed exactly like quantization noise), so magnitude/z-score
      screens see nothing;
    * the rounding error of that self-chosen coarse grid — up to
      ``kappa/2`` code steps per coordinate — is not noise to the
      attacker: it is *budget*. The attack carries it as its EF
      residual and re-injects it every round, so directional pushes
      far below one honest grid step accumulate across rounds and
      eventually cross the grid — influence a single shaped frame
      could never deliver, riding the same line search as
      :class:`InfluenceAscentAttack` (which this class extends: the
      magnitude knob stays adaptive).

    The countermeasure is PRE-decode: an honest blockwise encoder maps
    each block's absmax to exactly the code maximum, so its per-block
    inflation ratio ``qmax / max|code|`` is 1.0; this attack's frames
    sit at ~``kappa``. The serving ingress measures that ratio on the
    still-compressed frame (``wire.decode_with_stats``) and the
    forensics ``residual_shaping`` detector flags it — measured (recall
    + honest FP) by the ``subint8`` lane of
    ``benchmarks/chaos_bench.py``. ``apply`` returns the DECODED row
    (the wire view the frontend folds); ``wire_inflation`` exposes the
    pre-decode tell the in-process engines thread into
    ``ServingFrontend.submit(wire_inflation=...)``, exactly what the
    TCP ingress would have measured from the frame."""

    name = "residual-shaping"

    def __init__(
        self,
        dim: int,
        *,
        mode: str = "s4",
        block: int = 256,
        kappa: float = 4.0,
        direction: Any = None,
        scale0: float = 0.05,
        grow: float = 1.6,
        shrink: float = 0.5,
        max_scale: float = 1e3,
        seed: int = 0,
        client_id: str = "byz",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(
            dim, direction=direction, scale0=scale0, grow=grow,
            shrink=shrink, max_scale=max_scale, seed=seed,
            client_id=client_id, device=device,
        )
        if mode not in _SHAPE_MODES:
            raise ValueError(
                f"mode must be one of {sorted(_SHAPE_MODES)}, got {mode!r}"
            )
        if kappa < 1.0:
            raise ValueError(f"kappa must be >= 1 (got {kappa})")
        if block <= 0:
            raise ValueError(f"block must be positive, got {block}")
        self.mode = mode
        self.block = int(block)
        self.kappa = float(kappa)
        #: the attacker's EF residual: everything its shaped grid has
        #: "lost" so far and will re-inject (attacker-controlled state —
        #: the reason sub-int8 EF needs its own detector)
        self.residual = np.zeros((dim,), np.float32)
        #: pre-decode inflation ratio of the LAST emitted frame (what
        #: the ingress would measure; ~kappa while shaping)
        self.wire_inflation: float = 1.0

    def apply(self, *, model=None, x=None, y=None,
              honest_grads=None, base_grad=None) -> torch.Tensor:
        """Next submission: consensus estimate + line-searched push +
        carried residual, round-tripped through the attacker's own
        kappa-shaped encoder. The decoded row is what lands in the
        cohort; the residual update is exactly EF's."""
        self.submissions += 1
        target = (
            self._aggregate_estimate()
            + self.scale * self.direction
            + self.residual
        ).astype(np.float32)
        decoded, self.wire_inflation = _shaped_wire_roundtrip(
            target, self.mode, self.block, self.kappa
        )
        self.residual = target - decoded
        return self._emit(decoded)


__all__ = [
    "AdaptiveAttack",
    "InfluenceAscentAttack",
    "KrumEvasionAttack",
    "PublicRoundState",
    "ResidualShapingAttack",
    "StalenessAbuseAttack",
]
