"""AdamW with clipping and a warmup-cosine schedule (:mod:`.adamw`)."""
