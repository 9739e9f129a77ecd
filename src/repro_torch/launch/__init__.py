"""Entry points that serve and train the model zoo, its roofline, and the
meshes and rank world of the mesh-sharded fused executor."""
