from hgaprec_jax.parallel.sharded import (ShardedRun, build_sharded_run,
                                          make_mesh)

__all__ = ["ShardedRun", "build_sharded_run", "make_mesh"]
