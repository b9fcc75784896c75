"""Multi-GPU serving and training over a ``(dp, tp)`` grid of rank processes.

Port of :mod:`tiny_audio_tpu.parallel`: :mod:`.mesh` holds the sharding
rules and the grid, :mod:`.launch` the rank processes and the dispatch of
model calls from rank 0, :mod:`.dryrun` drives it all on a tiny model.
"""
