"""Multi-device rendering: device meshes, framebuffer, sample and scene
sharding (``sharding.py``, ``scene_shard.py``)."""
