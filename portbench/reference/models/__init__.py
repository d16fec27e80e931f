"""Robot models: DogBot constants and single-rigid-body dynamics."""
