"""GeckOpt's agent side: intents, the tool registry and generated
catalogs, the intent gate, the retriever, the planner, the tool-graph
compiler and the agent (copies of the JAX package's ``core`` with the
imports pointed at the port; only the retriever's scoring is torch)."""
