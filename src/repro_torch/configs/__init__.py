"""LM architecture configs: `base.ArchConfig`, the registry
(`get_arch`, `list_archs`) and the 11 registered architectures, each a
copy of the reference's file with its citation."""
