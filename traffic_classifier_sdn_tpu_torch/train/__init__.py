"""Trainers of the port: the fits the drift loop's background retrain
reaches (serving/retrain.fit_family) — ``forest``, ``gnb``, ``knn``,
``svc``, ``logreg`` and ``kmeans`` (which the IVF tier's coarse quantizer,
ops/knn_ivf.py, fits with too)."""
