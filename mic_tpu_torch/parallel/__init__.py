"""Data-parallel and FSDP training over torch.distributed
(mic_tpu/parallel/): the process bootstrap (distributed.py), the
("data", "model") mesh (mesh.py) and the param sharding rules
(sharding.py)."""

from mic_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh  # noqa: F401
from mic_tpu_torch.parallel.sharding import param_specs, spec_for  # noqa: F401
