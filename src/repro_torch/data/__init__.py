"""Deterministic LM token streams: synthetic and binary shards
(:mod:`.pipeline`)."""
