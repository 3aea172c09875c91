"""knn_topk_roofline.replay: the KNN kernel (``csrc/knn_topk.cu``): least time of the traced
predicts' work (``yardstick.knn_bound``) over the device time of the
``knn_topk`` kernels in the trace, %.
Moves ``flows_per_s``."""

from harness import readers


def read(run):
    return readers.roofline(run, "knn", "knn_topk")
