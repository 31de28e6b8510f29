"""Launchers and the dry run: ``train`` (the one-card training entry
point), ``mesh`` (shape-only meshes), ``sharding`` (partition rules),
``hlostats`` (a dispatch-level op counter) and ``dryrun``."""
