"""Operations of the density main path on tensors."""
