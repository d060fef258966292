"""Launch: the training CLI (``train``), the step programs (``steps``) and
the roofline (``roofline``) of the reference's ``launch/``.

Not ported, as they have no counterpart on one card: ``dryrun`` (lowers
every step program for 512 placeholder XLA devices), ``sharding`` (GSPMD
partition specs) and ``mesh`` (the production device meshes).
"""
