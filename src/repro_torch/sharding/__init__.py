from repro_torch.sharding.ctx import (  # noqa: F401
    ShardingCtx,
    current_ctx,
    set_ctx,
    shard_constraint,
    use_ctx,
)
