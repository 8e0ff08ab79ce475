"""The benchmark's plain reference: frozen copies of the frame pipeline
and the motion-only pose solve in plain PyTorch, and the trajectory and
world arithmetic in NumPy.  Imports nothing of the program under test.
"""
