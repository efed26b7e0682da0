"""The simulated geospatial platform the agent acts in: the world, the
task generator, the tool implementations and the evaluator (copies of
the JAX package's ``env``)."""
