"""Structure from motion: BAL problems and Schur bundle adjustment."""
