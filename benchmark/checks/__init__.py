"""The comparisons with the plain reference that decide `correct`."""
