"""The frame-embedding engine, the mesh, the collectives and the trainers."""
