"""The ssd_scan kernel family: wrapper, plain version, registry binding."""
