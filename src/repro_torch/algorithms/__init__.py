"""Paper §4 — the three benchmarking applications, task-parallel on the
port's runtime: KNN classification, K-means clustering, linear regression
with prediction.  Each module ships the task functions, a sequential-style
driver (the code a user writes, ``device=None`` = CUDA) and a single-shot
NumPy oracle, plus the simulator's cost calibration (``calibrate``) and
DAG generator (``dag_spec``)."""
from . import kmeans, knn, linreg  # noqa: F401
from .common import tree_reduce  # noqa: F401
