"""The rwkv6_scan_log kernel family: wrapper, plain version, registry binding."""
