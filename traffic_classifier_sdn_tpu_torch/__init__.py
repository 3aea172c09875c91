"""PyTorch/CUDA port of ``traffic_classifier_sdn_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
the name of its counterpart there, and the tests run the same inputs
through both. This package imports ``torch`` and nothing of JAX or of the
JAX package; where it needs code from a jax-free module there, it keeps
its own copy.

It covers the serial ``Randomforest``, ``knearest`` and ``svm`` classify
serves: the monitor pipe or a replay/synthetic source, the C++ ingest
engine (``native/``) or the Python batcher, incremental labels predicted
through a hand-written CUDA kernel (``csrc/forest_proba.cu``,
``csrc/knn_topk.cu``, ``csrc/rbf_decision.cu``), and the activity-ranked
render. Entry points run on CUDA unless the caller asks for the CPU.
"""
