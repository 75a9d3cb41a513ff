"""Operations of the estimators on tensors: kernels, neighbours,
clustering, factorizations."""
