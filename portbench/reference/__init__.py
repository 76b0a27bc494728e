"""The plain reference: PyTorch operations only, written from the method's
equations; it imports nothing of the port and takes nothing the port made."""
