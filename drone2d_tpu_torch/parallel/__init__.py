from drone2d_tpu_torch.parallel.mesh import make_group, shard_init, shard_update

__all__ = ["make_group", "shard_init", "shard_update"]
