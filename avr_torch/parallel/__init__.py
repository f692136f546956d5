"""Multi-device training: the data × ray plan on ``torch.distributed``."""

from avr_torch.parallel.mesh import MeshPlan, initialize_multihost, make_mesh_plan  # noqa: F401
