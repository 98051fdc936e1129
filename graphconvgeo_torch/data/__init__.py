"""Host data layer: dump loading, mention graph, TF-IDF, k-d tree labels, preprocessing."""
