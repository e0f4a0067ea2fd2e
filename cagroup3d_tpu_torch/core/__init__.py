"""Sparse voxel engine (eval): hashing, voxelization, kernel maps, convs,
pooling, geometry and NMS."""
