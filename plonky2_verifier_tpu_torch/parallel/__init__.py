"""The streaming batch loop: one circuit shape (StreamVerifier) or many
(BucketedStreamVerifier) through TorchVerifier, on one device or, with
`mesh=`, as one process a device (mesh.py: make_mesh, ShardedVerifier;
stream.init_distributed joins the processes).
"""

from .mesh import Mesh, ShardedVerifier, join_group, make_mesh, run_ranks, verify_sharded  # noqa: F401
from .stream import BucketedStreamVerifier, StreamVerifier, init_distributed, template_key  # noqa: F401
