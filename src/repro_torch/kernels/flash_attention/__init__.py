"""The flash_attention kernel family: wrapper, plain version, registry binding."""
