"""Launch: the training CLI (``train``), the step programs (``steps``),
the roofline (``roofline``), and the sharded program of the reference's
``launch/``: the device meshes (``mesh``, ``DeviceMesh`` over a process
group), the partition rules (``sharding``, DTensor placements) and the dry
run (``dryrun``: the step programs traced on fake groups of 256 or 512
ranks, one device's work counted).
"""
