"""Config, device selection and the flax weight bridge."""
