"""The Pianist worker on torch tensors."""
