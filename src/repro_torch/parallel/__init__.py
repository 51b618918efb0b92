from repro_torch.parallel.sharding import Sharder, mesh_axis_sizes  # noqa: F401
