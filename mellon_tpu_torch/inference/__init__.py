"""Loss, optimizer and predictors of the density model."""
