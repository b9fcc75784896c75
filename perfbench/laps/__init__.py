"""Kinds of laps: ``laps/<name>.py`` drives one kind of unit in the window.

A module gives ``KIND``, ``END_TO_END`` (metric name -> unit) and a class
``Lap(spec, cfg, seed, device)`` with ``setup()``, ``unit()``, ``metrics(
units, window_s)``, ``context(units)`` (the per-layer readers' shapes),
``phases(unit)`` (``[(start, phase name)]``), ``release()`` and ``check() -> checks``, where a
check is ``{name: {"value", "limit"}}`` and passes when value <= limit.
"""
