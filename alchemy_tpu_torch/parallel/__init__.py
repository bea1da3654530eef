from alchemy_tpu_torch.parallel.mesh import make_mesh, pick_mesh_shape

__all__ = ["make_mesh", "pick_mesh_shape"]
