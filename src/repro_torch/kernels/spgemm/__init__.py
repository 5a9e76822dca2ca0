"""The spgemm kernel family (expansion multiply, transpose permutation):
wrappers, plain versions, registry binding."""
