"""Kernel autotuner: search the layout space, persist the winner.

Torch counterpart of ``repro/tune/tuner.py``.  The entry point is
:func:`resolve_plan`, called by ``core/registry.ExecutorRegistry.create``
whenever the engine config asks for tuning (``LifeConfig.tune != "off"``):

  * ``tune="cached"`` replays a persisted :class:`~repro_torch.tune.plan.TunePlan`
    if the cache holds one for this (dataset, geometry, executor, backend,
    device count, requested dtype) key; on a miss it runs the config's own
    constants (reason "untuned"), measures nothing and persists nothing.
  * ``tune="full"`` takes the same warm hit (a rebuild on tuned data makes
    no measurement); on a miss it measures every candidate of
    :func:`repro_torch.tune.space.search_space` through the shared loop of
    :mod:`repro_torch.tune.search` and persists the winner.

Each candidate is measured as a bound executor, built by the same factory
the engine uses, at a cost of ``2 x DSC + 1.5 x WC``: the per-iteration
op mix of SBBNNLS.  On the card the candidates run the CUDA kernels
(B1/B2 for ``kernel``, B3/B4 for ``kernel-sell`` and, once per mesh
cell, for ``shard-sell``, B5/B6 for ``kernel-fcoo``); a candidate that
fails to build or launch raises.  A mesh executor's candidates are built
on the config's ``(shard_rows, shard_cols)``, which the key carries.  On
CPU tensors they run their plain versions, under a ``cpu`` key that the
card never replays.

A ``tune="cached"`` miss first asks the learned predictor beside the
cache (:func:`_predicted`, ``repro_torch.learn``): it replays the nearest
trained dataset's winning params for this ``executor@backend`` with zero
measurements (``reason="predicted"``, persisted, counted in
``learn.predict``) and queues a ``tune="full"`` re-resolve on
:data:`repro_torch.learn.refine.QUEUE`, which overwrites the plan in
place.  A cached predicted plan counts as a miss under ``tune="full"``;
under ``"cached"`` a hit on one re-queues its refinement.  A search
records the reference's
``tune.search`` span and its ``tune.searches``, ``tune.measurements`` and
``tune.measurements.per_search`` instruments.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.bridge import to_numpy
from repro_torch.tune import search
from repro_torch.tune.plan import COMPUTE_DTYPES, TUNE_MODES, TunePlan
from repro_torch.tune.space import current_params, search_space, tile_axes

#: SBBNNLS per-iteration op mix: DSC twice an iteration, WC on three
#: iterations of two (the weighting formats/select.py measures under)
DSC_WEIGHT = 2.0
WC_WEIGHT = 1.5


def backend_name(device: torch.device) -> str:
    """The platform tag tune keys are scoped by: the device type (cpu /
    cuda)."""
    return torch.device(device).type


def device_count(backend: str) -> int:
    """Devices of ``backend`` the key records: 1 on the CPU, every visible
    card on cuda."""
    return torch.cuda.device_count() if backend == "cuda" else 1


def _resolved_dtype(config) -> str:
    dt = getattr(config, "compute_dtype", "fp32")
    return "fp32" if dt == "auto" else dt


def validate_config(config) -> None:
    """Shared engine-side validation of the tuning knobs."""
    mode = getattr(config, "tune", "off")
    if mode not in TUNE_MODES:
        raise ValueError(f"tune must be one of {TUNE_MODES}, got {mode!r}")
    dt = getattr(config, "compute_dtype", "fp32")
    if dt not in COMPUTE_DTYPES + ("auto",):
        raise ValueError(
            f"compute_dtype must be one of {COMPUTE_DTYPES + ('auto',)}, "
            f"got {dt!r}")
    if dt == "auto" and mode == "off":
        raise ValueError(
            'compute_dtype="auto" is a searched axis; it needs '
            'tune="cached" or tune="full"')
    predict = getattr(config, "predict", "auto")
    if predict not in ("auto", "off"):
        raise ValueError(
            f'predict must be "auto" or "off", got {predict!r}')


def _untuned(name: str, config, backend: str) -> TunePlan:
    return TunePlan(executor=name, backend=backend,
                    n_devices=device_count(backend),
                    params=current_params(name, config),
                    compute_dtype=_resolved_dtype(config), reason="untuned")


def _phi_stats_for(phi, config) -> dict:
    from repro_torch.core.inspector import phi_stats
    return phi_stats(phi, row_tile=int(getattr(config, "row_tile", 8)),
                     slot_tile=int(getattr(config, "slot_tile", 32)))


def _predicted(name: str, key: str, phi, problem, config,
               cache) -> Optional[TunePlan]:
    """Zero-measurement rung for a ``tune="cached"`` miss.

    Replays the nearest trained dataset's winning params for this
    ``executor@backend``, kept to the axes the executor exposes, with any
    axis the example lacks taken from the config (a predicted plan is
    always a legal configuration).  Returns None (the caller runs the
    config's constants) when prediction is off, no predictor is trained,
    or there is nothing to predict: an executor without tile axes under a
    fixed dtype is fully determined already.
    """
    if getattr(config, "predict", "auto") == "off" or not cache.enabled:
        return None
    axes = tile_axes(name)
    requested = getattr(config, "compute_dtype", "fp32")
    if not axes and requested != "auto":
        return None
    from repro_torch.learn import load_predictor
    predictor = load_predictor(cache.directory)
    if predictor is None:
        return None
    backend = backend_name(phi.device)
    stats = _phi_stats_for(phi, config)
    payload = predictor.predict_tune(stats, executor=name, backend=backend)
    if payload is None:
        obs.counter("learn.predict", kind="tune", outcome="fallback").inc()
        return None
    obs.counter("learn.predict", kind="tune", outcome="hit").inc()
    params = current_params(name, config)
    params.update({ax: int(payload[ax]) for ax in axes if ax in payload})
    dtype = _resolved_dtype(config)
    if requested == "auto" and payload.get("compute_dtype") in COMPUTE_DTYPES:
        dtype = payload["compute_dtype"]
    plan = TunePlan(executor=name, backend=backend,
                    n_devices=device_count(backend), params=params,
                    compute_dtype=dtype, reason="predicted", stats=stats)
    cache.put_tune_plan(key, plan)
    _enqueue_refinement(name, key, phi, problem, config, cache)
    return plan


def _enqueue_refinement(name: str, key: str, phi, problem, config,
                        cache) -> None:
    """Queue a measured ``tune="full"`` re-resolve that overwrites a
    predicted plan in place (the full mode treats the cached predicted
    entry as a miss)."""
    from repro_torch.learn import refine

    def _task() -> None:
        resolve_plan(name, phi, problem, replace(config, tune="full"), cache)

    refine.QUEUE.push("tune", key, _task)


def resolve_plan(name: str, phi, problem, config, cache) -> Optional[TunePlan]:
    """TunePlan for executor ``name`` on ``phi`` per ``config.tune``.

    Returns None when tuning is off.  Never measures under "cached"; under
    "full" a warm cache hit also skips every measurement.
    """
    validate_config(config)
    mode = getattr(config, "tune", "off")
    if mode == "off":
        return None

    from repro_torch.core.plan_cache import tune_plan_key
    from repro_torch.core.registry import REGISTRY

    d = problem.dictionary
    backend = backend_name(phi.device)
    n_devices = device_count(backend)
    key = tune_plan_key(
        to_numpy(phi.atoms), to_numpy(phi.voxels), to_numpy(phi.fibers),
        sizes=(phi.n_atoms, phi.n_voxels, phi.n_fibers),
        n_theta=int(d.shape[1]), executor=name,
        fmt=REGISTRY.consumes(name), backend=backend, n_devices=n_devices,
        compute_dtype=getattr(config, "compute_dtype", "fp32"),
        budget=int(getattr(config, "tune_budget", 0)),
        mesh=(int(getattr(config, "shard_rows", 1)),
              int(getattr(config, "shard_cols", 1))))
    plan = cache.get_tune_plan(key)
    if plan is not None and plan.reason == "predicted":
        if mode == "full":
            plan = None       # the refinement path: measure and overwrite
        else:
            # still serving a prediction: make sure its refinement is
            # queued (a process restart drops the in-memory queue)
            _enqueue_refinement(name, key, phi, problem, config, cache)
    if plan is not None:
        return plan
    if mode == "cached":
        plan = _predicted(name, key, phi, problem, config, cache)
        # a miss: the config's constants, nothing persisted, so a later
        # tune="full" run can still search and fill this key
        return plan if plan is not None else _untuned(name, config, backend)

    candidates = search_space(name, config,
                              budget=getattr(config, "tune_budget", None))
    if len(candidates) == 1:
        # no layout axes and a fixed dtype: nothing to measure; persist
        # the plan so tune="cached" rebuilds hit instead of missing
        cand = candidates[0]
        plan = TunePlan(executor=name, backend=backend, n_devices=n_devices,
                        params=cand["params"],
                        compute_dtype=cand["compute_dtype"], reason="default")
        cache.put_tune_plan(key, plan)
        return plan

    w_probe = torch.ones((phi.n_fibers,), dtype=d.dtype, device=phi.device)
    y_probe = torch.ones((phi.n_voxels, d.shape[1]), dtype=d.dtype,
                         device=phi.device)

    def run(cand) -> float:
        cfg = replace(config, tune="off", compute_dtype=cand["compute_dtype"])
        if cand["params"]:
            cfg = replace(cfg, **cand["params"])
        ex = REGISTRY.create(name, phi, problem, cfg, cache)
        return (DSC_WEIGHT * search.time_call(ex.matvec, w_probe)
                + WC_WEIGHT * search.time_call(ex.rmatvec, y_probe))

    with obs.span("tune.search", {"executor": name,
                                  "candidates": len(candidates)}):
        best_i, costs = search.measure_candidates(candidates, run)
    # the cold path (a search builds and times every candidate), so the
    # instruments are fetched per call rather than held
    obs.counter("tune.searches", executor=name).inc()
    obs.counter("tune.measurements").inc(float(len(candidates)))
    obs.histogram("tune.measurements.per_search").observe(
        float(len(candidates)))
    winner = candidates[best_i]
    plan = TunePlan(executor=name, backend=backend, n_devices=n_devices,
                    params=winner["params"],
                    compute_dtype=winner["compute_dtype"], reason="search",
                    measurements=costs, stats=_phi_stats_for(phi, config))
    cache.put_tune_plan(key, plan)
    return plan


def tunable_executors() -> tuple:
    """Executor names with at least one tile axis (introspection helper)."""
    from repro_torch.tune.space import TUNABLE_TILES
    return tuple(sorted(TUNABLE_TILES))


__all__ = ["resolve_plan", "validate_config", "backend_name", "device_count",
           "tunable_executors", "DSC_WEIGHT", "WC_WEIGHT"]
