"""The sharded modules of the port (the JAX package's ``parallel/``): the
device mesh, the sharded flow table behind ``--shards``, and the
data- and state-sharded predicts of the forest, KNN and SVC families."""
