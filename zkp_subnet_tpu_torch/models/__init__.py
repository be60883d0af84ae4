"""KZG commitments and the SRS, on torch tensors."""
