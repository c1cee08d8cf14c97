"""Temporal-serving tuning (counterpart of ``tpuseg/video/autotune.py``).

``drift_threshold`` measures a clip's drift scale; ``autotune_budget`` picks
the cheapest temporal serving configuration whose ids agree with exact
serving on a calibration prefix at least as often as a target: fixed-N
cadences (with their free ``temporal_nearest`` variant) and budgeted
promotion (threshold from the prefix's own drift), cheapest first (cost = the
share of frames forwarded; ``_WARP_COST`` more with ``temporal_warp``).  No
candidate qualifying means exact serving.  ``tpuseg``'s numpy and control
flow, with two of its quirks kept for parity (ROADMAP.md section C): an
interval longer than the batch gets cost 1/N, below the 1/batch a batch
really computes, and intervals <= 1 are dropped without an error; budget
candidates get no ``+nearest`` variant (a user's ``--temporal-nearest`` rides
every candidate instead).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def drift_threshold(frames: Sequence[np.ndarray]) -> tuple[float, float]:
    """Drift scale of THIS content: host-side mean |delta| between
    consecutive frames (the 0..255 pixel-delta units of the device scan) ->
    (threshold between the sensor-noise floor and the motion signal, mean
    |delta|).  ``tpuseg``'s numpy, so both values are bit-equal."""
    deltas = np.stack(
        [
            np.abs(
                frames[i + 1].astype(np.int16) - frames[i].astype(np.int16)
            ).mean()
            for i in range(len(frames) - 1)
        ]
    )
    thresh = float(
        np.percentile(deltas, 25) * 0.5 + np.percentile(deltas, 75) * 0.5
    )
    return thresh, float(deltas.mean())


def default_ladder(batch: int) -> list[int]:
    """Ascending candidate budgets: ~1/8, 1/4, 1/2, 3/4 of the serve
    batch (deduped, each >= 1 and < batch)."""
    raw = (batch // 8, batch // 4, batch // 2, (3 * batch) // 4)
    return sorted({min(batch - 1, max(1, k)) for k in raw}) if batch > 1 else [1]


# gating + flow overhead of the warp path relative to plain reuse, as a
# computed-frame-fraction equivalent.  tpuseg's figure, taken on a TPU and
# kept for parity (the same ladder order); not yet measured on the H100
# (ROADMAP A24).  Warp is never "free", so it sorts after every
# same-cadence alternative.
_WARP_COST = 0.1


def candidate_ladder(
    batch: int,
    ks: Sequence[int] | None = None,
    intervals: Sequence[int] | None = None,
    include_nearest: bool = True,
    include_warp: bool = False,
) -> list[dict]:
    """Build the cheapest-first candidate list over both temporal families.

    Each candidate: ``{"mode", "cost", "kwargs"}`` where ``kwargs`` are
    VideoSegmenter temporal options (budget candidates get their
    ``temporal_thresh`` filled in at tune time).  ``intervals=()``
    restricts the search to budget modes (the pre-round-5 behavior);
    ``ks=()`` restricts it to cadence modes.
    """
    cands: list[dict] = []
    for n in (intervals if intervals is not None else (8, 4, 2)):
        n = int(n)
        if n <= 1:
            continue
        base = {"temporal_interval": n}
        if include_nearest:
            cands.append({
                "mode": f"interval{n}+nearest", "cost": 1.0 / n, "_pref": 0,
                "kwargs": {**base, "temporal_nearest": True},
            })
        cands.append({
            "mode": f"interval{n}", "cost": 1.0 / n, "_pref": 1,
            "kwargs": base,
        })
        if include_warp:
            cands.append({
                "mode": f"interval{n}+warp", "cost": 1.0 / n + _WARP_COST,
                "_pref": 3, "kwargs": {**base, "temporal_warp": True},
            })
    ladder = (sorted({int(k) for k in ks}) if ks is not None
              else default_ladder(batch))
    if not all(0 < k <= batch for k in ladder):
        raise ValueError(f"budget candidates {ladder} must be in 1..{batch}")
    for k in ladder:
        cands.append({
            "mode": f"budget{k}", "cost": k / batch, "_pref": 2,
            "kwargs": {"temporal_budget": k},
        })
        if include_warp:
            cands.append({
                "mode": f"budget{k}+warp", "cost": k / batch + _WARP_COST,
                "_pref": 3,
                "kwargs": {"temporal_budget": k, "temporal_warp": True},
            })
    cands.sort(key=lambda c: (c["cost"], c["_pref"]))
    for c in cands:
        del c["_pref"]
    return cands


def autotune_budget(
    make_segmenter: Callable[..., object],
    calib_frames: Sequence[np.ndarray],
    *,
    target_agreement: float,
    batch: int,
    ks: Sequence[int] | None = None,
    intervals: Sequence[int] | None = None,
    include_nearest: bool = True,
    include_warp: bool = False,
) -> dict:
    """Pick the cheapest temporal serving config meeting an agreement floor.

    ``make_segmenter(**temporal_kwargs)`` must build a ``VideoSegmenter`` with
    every NON-temporal serving option already bound (quantization, sparse
    plans, transport, ...), so candidates are measured in exactly the
    configuration that will serve.  Called with no kwargs it must build
    the exact per-frame baseline.

    Returns a dict with:

    - ``choice``: the winning candidate's mode label (None -> serve exact),
    - ``choice_kwargs``: its VideoSegmenter temporal kwargs ({} -> exact),
    - ``temporal_thresh`` / ``drift_mean``: this content's drift scale,
    - ``temporal_budget``: the chosen K when a budget mode won (kept for
      the pre-round-5 result shape; None otherwise),
    - ``table``: per-candidate ``{mode, cost, agreement}`` in evaluation
      (cheapest-first) order; budget entries also carry ``budget``.
    """
    from tpuseg_torch.ops.quant import ids_agreement

    frames = list(calib_frames)
    if len(frames) < max(2, batch):
        raise ValueError(
            f"autotune needs at least max(2, batch)={max(2, batch)} "
            f"calibration frames, got {len(frames)}"
        )
    thresh, drift_mean = drift_threshold(frames)
    # one rounding, used everywhere (candidates, choice_kwargs, report) —
    # the served threshold must be byte-identical to the reported one
    thresh = round(thresh, 3)
    cands = candidate_ladder(
        batch, ks=ks, intervals=intervals,
        include_nearest=include_nearest, include_warp=include_warp,
    )
    exact_ids = np.stack(make_segmenter().run(frames, need_color=False)["ids"])
    table = []
    choice = None
    for cand in cands:
        kwargs = dict(cand["kwargs"])
        if "temporal_interval" in kwargs:
            # a cadence longer than half the prefix computes <2 frames —
            # its agreement estimate would be meaningless; skip, do not
            # silently accept (no-silent-caps rule)
            if kwargs["temporal_interval"] > len(frames) // 2:
                table.append({"mode": cand["mode"], "cost": round(cand["cost"], 4),
                              "agreement": None,
                              "skipped": "cadence exceeds calibration prefix"})
                continue
        if "temporal_budget" in kwargs:
            kwargs["temporal_thresh"] = thresh
        seg = make_segmenter(**kwargs)
        ids = np.stack(seg.run(frames, need_color=False)["ids"])
        n = min(len(ids), len(exact_ids))
        agr = float(ids_agreement(ids[:n], exact_ids[:n]))
        row = {"mode": cand["mode"], "cost": round(cand["cost"], 4),
               "agreement": round(agr, 4)}
        if "temporal_budget" in cand["kwargs"]:
            row["budget"] = cand["kwargs"]["temporal_budget"]
        table.append(row)
        if agr >= target_agreement:
            # cheapest-first order: the first qualifying candidate wins
            choice = {"mode": cand["mode"], "kwargs": kwargs}
            break
    return {
        "choice": choice["mode"] if choice else None,
        "choice_kwargs": dict(choice["kwargs"]) if choice else {},
        "temporal_thresh": round(thresh, 3),
        "temporal_budget": (choice["kwargs"].get("temporal_budget")
                            if choice else None),
        "drift_mean": round(drift_mean, 3),
        "target_agreement": target_agreement,
        "calib_frames": len(frames),
        "table": table,
    }
