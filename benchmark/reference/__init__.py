"""The benchmark's plain reference: geometry, the bundle-adjustment window
and its LM solve, and the rotation RMSE, in plain torch and numpy. It
imports nothing of the program under test."""
