from .density import compute_density, density_grid, make_grid  # noqa: F401
from .geometry_eval import evaluate_mesh_geometry  # noqa: F401
from .marching import (largest_component, marching_tetrahedra,  # noqa: F401
                       mesh_stats, sample_surface, vertex_normals)
from .meshio import (read_ply, write_obj, write_ply_mesh,  # noqa: F401
                     write_stl)
