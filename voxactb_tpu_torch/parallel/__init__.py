"""The train step split over ranks: meshes, shardings and the multi-process dry run."""
