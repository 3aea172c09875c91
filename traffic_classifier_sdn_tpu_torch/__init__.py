"""PyTorch/CUDA port of ``traffic_classifier_sdn_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
the name of its counterpart there, and the tests run the same inputs
through both. This package imports ``torch`` and nothing of JAX or of the
JAX package; where it needs code from a jax-free module there, it keeps
its own copy.

It covers the six classify serves of the JAX CLI (``python -m
traffic_classifier_sdn_tpu_torch <subcommand>``) at the JAX defaults: the
monitor pipe, the port's own OpenFlow controller, a replay, synthetic or
workload source, or many through the fan-in tier; the C++ ingest engine
(``native/``) or the Python batcher; incremental labels predicted through
a hand-written CUDA kernel (``csrc/forest_proba.cu``, ``csrc/knn_topk.cu``,
``csrc/rbf_decision.cu``) or the serving menus' other forms; the pipeline,
the degrade ladder and the activity-ranked render; the
metrics and observability plane (``utils/metrics.py``, ``obs/``) and
crash-safe serving checkpoints in the JAX package's format
(``io/serving_checkpoint.py``). Entry points run on
CUDA unless the caller asks for the CPU.
"""
