"""Core pieces (port of ``repro.core``): so far the Chandy-Lamport
snapshot of the exact detector.  The reference's other ``core`` modules
only re-export newer ones and have no counterpart."""
