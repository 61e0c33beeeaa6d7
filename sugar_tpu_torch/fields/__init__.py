"""KNN, Gaussian density / SDF fields, regularizers and normals."""
