"""Trainers of the port. Only ``kmeans`` so far: the IVF tier's coarse
quantizer (ops/knn_ivf.py) fits with it."""
