"""The reference's trunk families, one file each, named after the
configuration's MODEL.BACKBONE.NAME (`model.build_bottom_up` finds them by
that name); each file's `build(cfg, dtype)` returns the trunk."""
