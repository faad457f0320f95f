"""Scenario-axis data parallelism over device meshes (SURVEY.md §2.6/§5.8).

The reference has no parallelism at all (one robot, one process, 3 boost
threads); its N-scenario story is "launch Gazebo N times".  Here the
scenario axis is a first-class mesh dimension: vmap within a chip,
shard_map across chips/hosts, XLA collectives (psum/pmean) for sweep
statistics — ICI within a slice, DCN across slices, no hand-rolled
transport.
"""

from . import mesh  # noqa: F401
