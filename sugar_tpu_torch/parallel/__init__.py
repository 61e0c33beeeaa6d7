"""The multi-device paths on ``torch.distributed``: one process per rank
(``launch``), the collectives written out (``comm``), the (data, gauss)
mesh (``mesh``), and the sharded render, train steps, loops, ring KNN and
level set. Port of ``sugar_tpu/parallel/``."""
