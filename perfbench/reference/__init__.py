"""The plain reference: plain torch, no part of the program."""
