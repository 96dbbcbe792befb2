"""The plain reference of the benchmark: the DTZS and v2 container layouts,
the rANS sections, the DPK id packing and the codec's arithmetic, in NumPy
(and PyTorch for the bfloat16 control), written from the formats'
definitions. It imports neither jax nor either codec package, and takes
nothing the program made but the containers and outputs it judges."""
