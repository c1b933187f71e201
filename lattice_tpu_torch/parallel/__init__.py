"""Sharding over a device mesh: the corpus, the rank columns, the edge
lists and the encoder's batch, each split over logical shards."""
