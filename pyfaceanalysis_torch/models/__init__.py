"""HiGSFA network forward: expansions, SFA nodes, layered networks."""
