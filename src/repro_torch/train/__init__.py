"""The LM train step: loss, gradient accumulation, AdamW (`step`)."""
