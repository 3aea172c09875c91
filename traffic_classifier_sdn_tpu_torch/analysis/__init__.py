"""Analysis toolkit of the port: preprocessing (StandardScaler, PCA),
evaluation (accuracy, confusion matrix) and cluster→label mode matching
as torch ops on the caller's device — the counterpart of
``traffic_classifier_sdn_tpu/analysis/`` (the reference's notebook
analysis cells, SURVEY.md §2 C13: 1_log_Kmeans.ipynb cells 70-129).
``figures`` draws the notebook's four figures; it imports matplotlib only
inside its drawing functions."""

from .eval import accuracy, confusion_matrix, match_clusters  # noqa: F401
from .preprocess import PCA, StandardScaler  # noqa: F401
