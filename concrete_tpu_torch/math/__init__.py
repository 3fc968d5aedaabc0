"""Torus math for the port: gadget decomposition, negacyclic polynomials."""
