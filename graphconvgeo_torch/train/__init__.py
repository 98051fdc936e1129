"""Full-graph training and geolocation evaluation."""
