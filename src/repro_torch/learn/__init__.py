"""Learned zero-measurement format/executor selection.

Torch counterpart of ``repro/learn``.  Harvest (``phi_stats`` features ->
chosen plan) pairs from persisted FormatPlans and TunePlans, fit a tiny
numpy model, and answer plan-cache misses from it with **zero**
measurements (``reason="predicted"``), demoting measured selection and
autotuning to a background refinement that overwrites the cache entry in
place.

Modules: :mod:`features` (schema), :mod:`model` (centroid classifier +
nearest-example params), :mod:`harvest` (cache walk, train, load),
:mod:`refine` (the background queue the serve frontend drains).
"""
from repro_torch.learn.features import (FEATURE_NAMES,  # noqa: F401
                                        FEATURE_SCHEMA, feature_vector)
from repro_torch.learn.harvest import (PREDICTOR_FILENAME,  # noqa: F401
                                       clear_load_memo, harvest,
                                       load_predictor, predictor_path,
                                       train_predictor)
from repro_torch.learn.model import (CentroidClassifier,  # noqa: F401
                                     NearestExample, Predictor)
from repro_torch.learn.refine import (QUEUE, RefineQueue,  # noqa: F401
                                      run_pending)
