"""Core lattice algebra of the port: geometry, gamma matrices, SU(3)
fields, the full-lattice Wilson operator, the even-odd hopping blocks
and the Krylov solvers."""
