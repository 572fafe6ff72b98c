"""repro_torch.launch — the launch layer: solver meshes over
``torch.distributed`` (``mesh``) and one-host rank processes (``spawn``)."""
from repro_torch.launch.mesh import (SolverMesh, make_production_mesh,
                                     make_solver_mesh, make_test_mesh)
from repro_torch.launch.spawn import spawn_ranks

__all__ = ["SolverMesh", "make_production_mesh", "make_test_mesh",
           "make_solver_mesh", "spawn_ranks"]
