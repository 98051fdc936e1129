"""Plain references the benchmark's check holds the port against; they
import nothing of the port."""
