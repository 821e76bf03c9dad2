"""Lane sharding of a render over devices (port of parallel/)."""
from .sharding import make_mesh, ShardedRenderer
