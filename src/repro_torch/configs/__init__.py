"""Model configurations of the zoo (copied from `repro.configs`)."""
