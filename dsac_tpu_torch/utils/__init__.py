"""Weight carry-over from the reference's npz artifacts."""
