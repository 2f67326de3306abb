from .mesh import (Mesh, data_world, fit_data_mesh,  # noqa: F401
                   init_data_parallel, make_mesh, rank_rows, replicate,
                   shard_batch)
