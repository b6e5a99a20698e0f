"""AdamW with decoupled weight decay, global-norm clipping and schedules (`adamw`)."""
